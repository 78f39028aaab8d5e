// The cascade's finish kernel: from kernel A-cascade's per-tile partials,
// the next round's scales, ladder top and depth, on the device (sm_90a).
//
// Replaces no TPU kernel. It is the rest of the native engine's cascade
// round (native/stengine.cpp's send loop over native/stcodec.c's
// stc_quantize_ef_cascade partials, the engine's scales_from_partials), which
// the device tier ran as some 70 small torch launches a round
// (ops/table.compute_scales, cascade_ladder and the stop rule) before each
// A-cascade pass. One block of kThreads threads: 512 for a table of at most
// kFewLeaves leaves, else 1024 (ops/codec_cuda.finish_threads):
//
// 1. the state (j0, kc, stop) of the round just quantized, or of none when
//    `first`: once stopped it returns at once, before it reads a partial;
//    j0 advances by the round's kc; a round whose last scale row is all
//    zero (the subnormal floor, where the engine ends its message) stops
//    every later one, and so does a burst with no frame left, both before
//    anything is measured;
// 2. each leaf's partials reduced in a fixed order into leaf sums (max |r|,
//    sum r^2, sum |r|, double), by the block reduction that the per-leaf
//    scale pass (leaf_scale.cu) shares (scale_common.cuh: a range of
//    consecutive slots a warp, lane i over slots wb + 32 m + i, a tree a
//    leaf's part, a warp a leaf over several ranges); the first rows' loads
//    are issued beside the leaf bounds and the state's checks. A warp
//    closes its leaves one after another, so a table of many leaves takes
//    1024 threads, and one of few fewer trees with 512;
// 3. the scales by the host tier's rule (scale_common.cuh's scale_rule,
//    ops/codec_np.compute_scales_np):
//    POW2_RMS and RMS take sqrt(ss / n) in double, rounded to f32, POW2_RMS
//    then floored to a power of two; ABS_MEAN takes sabs / n; 0 where max
//    |r| is 0 or the scale is not finite. Without per_leaf, one sum over
//    the leaves, warp 0's: lane i sums the leaves i, i + 32, ... in turn,
//    then a shuffle tree;
// 4. the ladder by ops/table.cascade_ladder's rule: a live leaf's top is
//    pow2_floor(max |r|) where that exceeds its scale; the depth is the
//    largest ilogb(top) - ilogb(scale) + 1, plus 8 above 1, capped by
//    min(cap, K - j0), and 0 (stop) when no leaf is live. ladder[3][L] holds
//    the scales, each leaf's max |r| (f32) and the tops A-cascade reads.
//
// Bound: latency (one block; it reads 24 B a slot of partials and writes a
// few KB): a chain of short dependent steps (the state, one round trip of
// loads, the ranges' trees, the leaves' lists, the scales). No float
// atomics: the reduction order is fixed, so every run gives the same bits,
// and the plain twin (ops/codec_cuda.cascade_round_plain) repeats it. Built
// without fast-math: double division and sqrt are IEEE, subnormal scales
// are kept. leaf_slots runs from 0 to the partials' slot count, below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scale_common.cuh"

namespace {

using st_scale::pow2_floor;
constexpr int kFewLeaves = 16;   // at most this many leaves: 512 threads
constexpr int kExtraLevels = 8;  // CASCADE_EXTRA_LEVELS

// floor(log2 x) of a finite x > 0, subnormals included (C's ilogbf)
__device__ __forceinline__ int ilogb_pos(float x) {
  const unsigned u = __float_as_uint(x);
  const int e = (int)(u >> 23);
  return e ? e - 127 : (31 - __clz((int)u)) - 149;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
cascade_round_kernel(const double* __restrict__ partials, const long long* __restrict__ leaf_slots,
                     const double* __restrict__ ns, const float* __restrict__ scales,
                     int* __restrict__ state, float* __restrict__ ladder,
                     double* __restrict__ leaf_sums, int n_slots, int n_leaves, int k_frames,
                     int cap, int policy, int per_leaf, int first) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kSharedLeaves = kThreads - 1;  // leaves whose bounds, counts and sums stay in shared memory
  __shared__ int s_maxd;
  __shared__ double s_all[4];  // max |r|, sum r^2, sum |r|, n over every leaf
  __shared__ int s_bounds[kSharedLeaves + 1];
  __shared__ double s_ns[kSharedLeaves];
  __shared__ double s_sums[3][kSharedLeaves];
  __shared__ float s_scale[kSharedLeaves];
  __shared__ double s_part[3 * kWarps];  // each warp's part of a leaf begun before its range
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int j0 = 0, kc_prev = 0;
  if (!first) {
    j0 = state[0];
    kc_prev = state[1];
    if (state[2]) return;  // uniform: every thread read the same state
  }
  // one round trip of memory: the first kRows rows of the warp's range,
  // the leaf bounds and counts and the last scale row, all issued before
  // any is used
  const int span = st_scale::range_span<kThreads>(n_slots);
  const int wb = min(warp * span, n_slots), we = min(wb + span, n_slots);
  st_scale::Rows rows0;
  st_scale::load_rows(partials, n_slots, wb, we, 0, lane, rows0);
  const bool staged = n_leaves <= kSharedLeaves;  // then a thread a leaf at most
  const int bound_t = staged && tid <= n_leaves ? (int)leaf_slots[tid] : 0;
  const double ns_t = staged && tid < n_leaves ? ns[tid] : 0.0;
  int nonzero = 0;
  if (kc_prev > 0) {
    const float* last = scales + (long long)(j0 + kc_prev - 1) * n_leaves;
    for (int l = tid; l < n_leaves; l += kThreads) nonzero |= last[l] != 0.0f;
  }
  if (tid == 0) s_maxd = 1;
  if (staged && tid <= n_leaves) s_bounds[tid] = bound_t;
  if (staged && tid < n_leaves) s_ns[tid] = ns_t;
  nonzero = __syncthreads_or(nonzero);  // also orders every state read before the write below
  j0 += kc_prev;
  if ((kc_prev > 0 && !nonzero) || j0 >= k_frames) {  // floored, or no frame left
    if (tid == 0) {
      state[0] = j0;
      state[1] = 0;
      state[2] = 1;
    }
    return;
  }
  // where the leaf bounds, counts and sums live: shared memory, or for a
  // table of more than kSharedLeaves leaves, global memory (leaf_sums)
  const int* sb = s_bounds;
  auto bound = [&](int l) { return staged ? sb[l] : (int)leaf_slots[l]; };
  auto leaf_n = [&](int l) { return staged ? s_ns[l] : ns[l]; };
  double* sums = staged ? &s_sums[0][0] : leaf_sums;
  const int stride = staged ? kSharedLeaves : n_leaves;

  st_scale::reduce_ranges<kWarps>(partials, n_slots, n_leaves, wb, we, bound, sums, stride, s_part, rows0);
  __syncthreads();
  st_scale::combine_ranges<kWarps>(n_leaves, span, bound, sums, stride, s_part);
  __syncthreads();
  if (!per_leaf) {
    if (warp == 0) st_scale::sum_leaves(n_leaves, sums, stride, leaf_n, s_all);
    __syncthreads();
  }

  int maxd = 1, live_any = 0;
  for (int l = tid; l < n_leaves; l += kThreads) {
    const double am = sums[l];
    const float s = per_leaf ? st_scale::scale_rule(am, sums[stride + l], sums[2 * stride + l], leaf_n(l), policy)
                             : st_scale::scale_rule(s_all[0], s_all[1], s_all[2], s_all[3], policy);
    const float amax = (float)am;  // the leaf's own, whatever per_leaf
    ladder[l] = s;
    ladder[n_leaves + l] = amax;
    if (staged) {
      s_scale[l] = s;
      leaf_sums[l] = am;
      leaf_sums[n_leaves + l] = sums[stride + l];
      leaf_sums[2 * n_leaves + l] = sums[2 * stride + l];
    }
    if (s > 0.0f) {
      live_any = 1;
      const float st = pow2_floor(amax);
      if (st > s) {
        const int d = ilogb_pos(st) - ilogb_pos(s) + 1;
        if (d > maxd) maxd = d;
      }
    }
  }
  atomicMax(&s_maxd, maxd);  // an integer max: the same whatever the order
  live_any = __syncthreads_or(live_any);
  int kc = s_maxd > 1 ? s_maxd + kExtraLevels : s_maxd;
  int left = k_frames - j0;
  if (cap < left) left = cap;
  if (kc > left) kc = left;
  if (!live_any || kc < 0) kc = 0;
  for (int l = tid; l < n_leaves; l += kThreads) {
    const float sl = staged ? s_scale[l] : ladder[l];
    ladder[2 * n_leaves + l] = (kc > 1 && sl > 0.0f) ? fmaxf(pow2_floor((float)sums[l]), sl) : sl;
  }
  if (tid == 0) {
    state[0] = j0;
    state[1] = kc;
    state[2] = kc == 0;
  }
}

}  // namespace

extern "C" int st_cascade_round(const double* partials, const long long* leaf_slots,
                                const double* ns, const float* scales, int* state, float* ladder,
                                double* leaf_sums, long long n_slots, int n_leaves, int k_frames,
                                int cap, int policy, int per_leaf, int first, void* stream) {
  if (n_leaves <= 0) return 0;
  if (n_slots >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n_leaves <= kFewLeaves)
    cascade_round_kernel<512><<<1, 512, 0, (cudaStream_t)stream>>>(
        partials, leaf_slots, ns, scales, state, ladder, leaf_sums, (int)n_slots, n_leaves, k_frames, cap,
        policy, per_leaf, first);
  else
    cascade_round_kernel<1024><<<1, 1024, 0, (cudaStream_t)stream>>>(
        partials, leaf_slots, ns, scales, state, ladder, leaf_sums, (int)n_slots, n_leaves, k_frames, cap,
        policy, per_leaf, first);
  return (int)cudaGetLastError();
}
