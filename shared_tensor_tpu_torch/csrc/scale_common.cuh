// The fixed-order scale arithmetic that the finish kernel (cascade_round.cu),
// the per-leaf scale pass (leaf_scale.cu) and the frame's scale pass
// (frame_scale.cu) share on Hopper (sm_90a). No float atomics: every sum
// runs in an order fixed by the launch shape alone, so every run gives the
// same bits and the plain twins in ops/codec_cuda.py repeat them.
//
// - warp_tree: a warp's shuffle tree over its lanes (max |r|, sum r^2,
//   sum |r| in double): lane i takes lane i + h for h = 16, 8, 4, 2, 1.
// - scale_rule: the host tier's rule (ops/codec_np.compute_scales_np):
//   POW2_RMS and RMS take sqrt(ss / n) in double, rounded to f32, POW2_RMS
//   then floored to a power of two; ABS_MEAN takes sabs / n; 0 where max |r|
//   is not above 0 or the scale is not finite.
// - Each leaf's partials into leaf sums, in one block of kThreads threads
//   (load_rows, reduce_ranges, combine_ranges): the slot range is cut into
//   one range of consecutive slots a warp, a multiple of 32 long (span), in
//   rows of 32: lane i takes slot wb + 32 m + i of row m. A warp loads kRows
//   rows at a time, every load issued before the first sum, and lane i sums
//   its slots of the open leaf in turn; a leaf's part ends with warp_tree (a
//   part of one slot is its lane's value, which the tree would give as
//   well). The range's first part of a leaf begun before it goes to s_part;
//   any other part (a whole leaf, or a leaf's first part) to the leaf's
//   sums. A leaf over several ranges is then one warp's: lane i sums the
//   parts i, i + 32, ... of its list (the first part, then the later
//   ranges' parts) in turn, then warp_tree. A leaf with no slots is 0.
// - sum_leaves: one sum over the leaves (per_leaf off), warp 0's: lane i
//   sums the leaves i, i + 32, ... in turn, then warp_tree.
// Built without fast-math: double division and sqrt are IEEE, subnormal
// scales are kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace st_scale {

constexpr int kRows = 4;  // rows of its range a warp loads before it sums them
enum { kPow2Rms = 0, kRms = 1, kAbsMean = 2 };

__device__ __forceinline__ float pow2_floor(float x) {
  return __uint_as_float(__float_as_uint(x) & 0x7F800000u);
}

__device__ __forceinline__ void warp_tree(double& amax, double& ss, double& sabs) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double a = __shfl_down_sync(0xffffffffu, amax, off);
    if (a > amax) amax = a;
    ss += __shfl_down_sync(0xffffffffu, ss, off);
    sabs += __shfl_down_sync(0xffffffffu, sabs, off);
  }
}

__device__ __forceinline__ float scale_rule(double amax, double ss, double sabs, double n, int policy) {
  float s;
  if (policy == kAbsMean) {
    s = (float)(sabs / n);
  } else {
    s = (float)sqrt(ss / n);
    if (policy == kPow2Rms) s = pow2_floor(s);
  }
  if (!(amax > 0.0) || !isfinite(s)) s = 0.0f;
  return s;
}

// a range's span for a block of kThreads threads over n_slots slots
template <int kThreads>
__device__ __forceinline__ int range_span(int n_slots) {
  return (n_slots + kThreads - 1) / kThreads * 32;
}

struct Rows {
  double a[kRows], q[kRows], b[kRows];
};

// rows c .. c + kRows - 1 of the warp's range [wb, we): lane's slots, 0 past it
__device__ __forceinline__ void load_rows(const double* __restrict__ partials, int n_slots, int wb, int we,
                                          int c, int lane, Rows& r) {
#pragma unroll
  for (int j = 0; j < kRows; j++) {
    const int t = wb + 32 * (c + j) + lane;
    r.a[j] = t < we ? partials[t] : 0.0;
    r.q[j] = t < we ? partials[n_slots + t] : 0.0;
    r.b[j] = t < we ? partials[2 * n_slots + t] : 0.0;
  }
}

// the warp's range [wb, we) row by row, its first kRows rows already in r;
// sums[k * stride + l] takes leaf l's part k (max |r|, sum r^2, sum |r|),
// s_part[k * kWarps + warp] the range's part of a leaf begun before it
template <int kWarps, class Bound>
__device__ __forceinline__ void reduce_ranges(const double* __restrict__ partials, int n_slots, int n_leaves,
                                              int wb, int we, Bound bound, double* sums, int stride,
                                              double* s_part, Rows& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (wb >= we) return;
  const int rows = (we - wb + 31) / 32;
  int l = 0;
  for (int lo = 0, hi = n_leaves - 1; lo < hi;) {  // the leaf of slot wb
    const int mid = (lo + hi + 1) >> 1;
    if (bound(mid) <= wb) lo = mid;
    else hi = mid - 1;
    l = lo;
  }
  int lo = bound(l), hi = bound(l + 1);
  double am = 0.0, ss = 0.0, sa = 0.0;
  auto close = [&]() {
    const int p0 = max(lo, wb), p1 = min(hi, we);
    // one slot: its lane holds the part, every other lane 0
    const bool one = p1 - p0 == 1;
    if (!one) warp_tree(am, ss, sa);
    if (lane == (one ? (p0 - wb) % 32 : 0)) {
      if (lo < wb) {
        s_part[warp] = am;
        s_part[kWarps + warp] = ss;
        s_part[2 * kWarps + warp] = sa;
      } else {
        sums[l] = am;
        sums[stride + l] = ss;
        sums[2 * stride + l] = sa;
      }
    }
    am = ss = sa = 0.0;
  };
  for (int c = 0; c < rows; c += kRows) {
    if (c > 0) load_rows(partials, n_slots, wb, we, c, lane, r);
    if (min(wb + 32 * (c + kRows), we) <= hi) {  // the chunk lies in the open leaf
#pragma unroll
      for (int j = 0; j < kRows; j++) {
        if (r.a[j] > am) am = r.a[j];  // a slot past the range holds 0
        ss += r.q[j];
        sa += r.b[j];
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kRows; j++) {
      if (c + j >= rows) break;
      const int t = wb + 32 * (c + j) + lane;
      const int row_end = min(wb + 32 * (c + j) + 32, we);
      while (true) {
        if (t < we && t >= lo && t < hi) {
          if (r.a[j] > am) am = r.a[j];
          ss += r.q[j];
          sa += r.b[j];
        }
        if (hi >= row_end) break;  // the leaf goes on past the row
        close();                   // the leaf ends in the row
        do {
          l++;
          lo = hi;
          hi = bound(l + 1);
        } while (lo == hi);  // a leaf with no slots is combine_ranges'
      }
    }
  }
  close();
}

// each leaf over several ranges, a warp's (after a barrier that follows
// reduce_ranges): lane i sums the parts i, i + 32, ... of its list in turn,
// then warp_tree; a leaf with no slots is 0
template <int kWarps, class Bound>
__device__ __forceinline__ void combine_ranges(int n_leaves, int span, Bound bound, double* sums, int stride,
                                               const double* s_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < n_leaves; l += kWarps) {
    const int lo = bound(l), hi = bound(l + 1);
    if (lo == hi) {
      if (lane == 0) sums[l] = sums[stride + l] = sums[2 * stride + l] = 0.0;
      continue;
    }
    const int wa = lo / span, wz = (hi - 1) / span;
    if (wa == wz) continue;  // one range's: written whole
    double am = 0.0, ss = 0.0, sa = 0.0;
    for (int i = lane; i <= wz - wa; i += 32) {
      const double x0 = i ? s_part[wa + i] : sums[l];
      const double x1 = i ? s_part[kWarps + wa + i] : sums[stride + l];
      const double x2 = i ? s_part[2 * kWarps + wa + i] : sums[2 * stride + l];
      if (x0 > am) am = x0;
      ss += x1;
      sa += x2;
    }
    warp_tree(am, ss, sa);
    if (lane == 0) {
      sums[l] = am;
      sums[stride + l] = ss;
      sums[2 * stride + l] = sa;
    }
  }
}

// warp 0 (the caller's): one sum over the leaves into s_all (max |r|, sum
// r^2, sum |r|, n), lane 0's; ns(l) is leaf l's live count
template <class Ns>
__device__ __forceinline__ void sum_leaves(int n_leaves, const double* sums, int stride, Ns ns, double* s_all) {
  const int lane = threadIdx.x & 31;
  double am = 0.0, s2 = 0.0, sa = 0.0, n = 0.0;
  for (int l = lane; l < n_leaves; l += 32) {
    if (sums[l] > am) am = sums[l];
    s2 += sums[stride + l];
    sa += sums[2 * stride + l];
    n += ns(l);
  }
  warp_tree(am, s2, sa);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  if (lane == 0) {
    s_all[0] = am;
    s_all[1] = s2;
    s_all[2] = sa;
    s_all[3] = n;
  }
}

}  // namespace st_scale
