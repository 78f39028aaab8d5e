// The cascade's finish kernel: from kernel A-cascade's per-tile partials,
// the next round's scales, ladder top and depth, on the device (sm_90a).
//
// Replaces no TPU kernel. It is the rest of the native engine's cascade
// round (native/stengine.cpp's send loop over native/stcodec.c's
// stc_quantize_ef_cascade partials, the engine's scales_from_partials), which
// the device tier ran as some 70 small torch launches a round
// (ops/table.compute_scales, cascade_ladder and the stop rule) before each
// A-cascade pass. One block of 1024 threads:
//
// 1. the state (j0, kc, stop) of the round just quantized, or of none when
//    `first`: once stopped it returns at once; j0 advances by the round's
//    kc; a round whose last scale row is all zero (the subnormal floor,
//    where the engine ends its message) stops every later one, and so does
//    a burst with no frame left, both before anything is measured;
// 2. each leaf's partials reduced in a fixed order (a warp a leaf: lane i
//    sums the leaf's slots i, i + 32, ... in turn, then a shuffle tree), into
//    leaf_sums[3][L] (max |r|, sum r^2, sum |r|, double);
// 3. the scales by the host tier's rule (ops/codec_np.compute_scales_np):
//    POW2_RMS and RMS take sqrt(ss / n) in double, rounded to f32, POW2_RMS
//    then floored to a power of two; ABS_MEAN takes sabs / n; without
//    per_leaf one sum over all leaves (in leaf order); 0 where max |r| is 0
//    or the scale is not finite;
// 4. the ladder by ops/table.cascade_ladder's rule: a live leaf's top is
//    pow2_floor(max |r|) where that exceeds its scale; the depth is the
//    largest ilogb(top) - ilogb(scale) + 1, plus 8 above 1, capped by
//    min(cap, K - j0), and 0 (stop) when no leaf is live. ladder[3][L] holds
//    the scales, each leaf's max |r| (f32) and the tops A-cascade reads.
//
// Bound: latency (one block; it reads 24 B a slot of partials and writes a
// few KB). No float atomics: the reduction order is fixed, so every run
// gives the same bits, and the plain twin (ops/codec_cuda.cascade_round_plain)
// repeats it. Built without fast-math: double division and sqrt are IEEE,
// subnormal scales are kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kExtraLevels = 8;  // CASCADE_EXTRA_LEVELS
enum { kPow2Rms = 0, kRms = 1, kAbsMean = 2 };

__device__ __forceinline__ float pow2_floor(float x) {
  return __uint_as_float(__float_as_uint(x) & 0x7F800000u);
}

// floor(log2 x) of a finite x > 0, subnormals included (C's ilogbf)
__device__ __forceinline__ int ilogb_pos(float x) {
  const unsigned u = __float_as_uint(x);
  const int e = (int)(u >> 23);
  return e ? e - 127 : (31 - __clz((int)u)) - 149;
}

__global__ void __launch_bounds__(kThreads)
cascade_round_kernel(const double* __restrict__ partials, const long long* __restrict__ leaf_slots,
                     const double* __restrict__ ns, const float* __restrict__ scales,
                     int* __restrict__ state, float* __restrict__ ladder,
                     double* __restrict__ leaf_sums, long long n_slots, int n_leaves, int k_frames,
                     int cap, int policy, int per_leaf, int first) {
  __shared__ int s_maxd;
  __shared__ double s_all[4];  // max |r|, sum r^2, sum |r|, n over every leaf
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int j0 = 0, kc_prev = 0;
  if (!first) {
    j0 = state[0];
    kc_prev = state[1];
    if (state[2]) return;  // uniform: every thread read the same state
  }
  if (tid == 0) s_maxd = 1;
  int nonzero = 0;
  if (kc_prev > 0) {
    const float* last = scales + (long long)(j0 + kc_prev - 1) * n_leaves;
    for (int l = tid; l < n_leaves; l += kThreads) nonzero |= last[l] != 0.0f;
  }
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

  for (int l = warp; l < n_leaves; l += kWarps) {
    const long long t1 = leaf_slots[l + 1];
    double amax = 0.0, ss = 0.0, sabs = 0.0;
#pragma unroll 4
    for (long long t = leaf_slots[l] + lane; t < t1; t += 32) {
      const double a = partials[t];
      if (a > amax) amax = a;
      ss += partials[n_slots + t];
      sabs += partials[2 * n_slots + t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double a = __shfl_down_sync(0xffffffffu, amax, off);
      if (a > amax) amax = a;
      ss += __shfl_down_sync(0xffffffffu, ss, off);
      sabs += __shfl_down_sync(0xffffffffu, sabs, off);
    }
    if (lane == 0) {
      leaf_sums[l] = amax;
      leaf_sums[n_leaves + l] = ss;
      leaf_sums[2 * n_leaves + l] = sabs;
    }
  }
  __syncthreads();
  if (!per_leaf) {
    if (tid == 0) {
      double a = 0.0, s2 = 0.0, sa = 0.0, n = 0.0;
      for (int l = 0; l < n_leaves; l++) {
        if (leaf_sums[l] > a) a = leaf_sums[l];
        s2 += leaf_sums[n_leaves + l];
        sa += leaf_sums[2 * n_leaves + l];
        n += ns[l];
      }
      s_all[0] = a;
      s_all[1] = s2;
      s_all[2] = sa;
      s_all[3] = n;
    }
    __syncthreads();
  }

  int maxd = 1, live_any = 0;
  for (int l = tid; l < n_leaves; l += kThreads) {
    const double a = per_leaf ? leaf_sums[l] : s_all[0];
    const double n = per_leaf ? ns[l] : s_all[3];
    float s;
    if (policy == kAbsMean) {
      s = (float)((per_leaf ? leaf_sums[2 * n_leaves + l] : s_all[2]) / n);
    } else {
      s = (float)sqrt((per_leaf ? leaf_sums[n_leaves + l] : s_all[1]) / n);
      if (policy == kPow2Rms) s = pow2_floor(s);
    }
    if (!(a > 0.0) || !isfinite(s)) s = 0.0f;
    const float amax = (float)leaf_sums[l];  // the leaf's own, whatever per_leaf
    ladder[l] = s;
    ladder[n_leaves + l] = amax;
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
    const float s = ladder[l];
    ladder[2 * n_leaves + l] = (kc > 1 && s > 0.0f) ? fmaxf(pow2_floor(ladder[n_leaves + l]), s) : s;
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
  cascade_round_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      partials, leaf_slots, ns, scales, state, ladder, leaf_sums, n_slots, n_leaves, k_frames, cap,
      policy, per_leaf, first);
  return (int)cudaGetLastError();
}
