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
//    sum r^2, sum |r|, double). The slot range is cut into one range of
//    consecutive slots a warp, a multiple of 32 long, in rows of 32: lane i
//    takes slot wb + 32 m + i of row m. A warp loads kRows rows at a time,
//    every load issued before the first sum (the first rows' beside the
//    leaf bounds and the state's checks), and lane i sums its slots of the
//    open leaf in turn; a leaf's part ends with a shuffle tree over the
//    lanes (a part of one slot is its lane's value, which the tree would
//    give as well). The range's first part of a leaf begun before it goes
//    to shared memory; any other part (a whole leaf, or a leaf's first
//    part) to the leaf's sums. A leaf over several ranges is then one
//    warp's: lane i sums the parts i, i + 32, ... of its list (the first
//    part, then the later ranges' parts) in turn, then a shuffle tree. A
//    warp closes its leaves one after another, so a table of many leaves
//    takes 1024 threads, and one of few fewer trees with 512;
// 3. the scales by the host tier's rule (ops/codec_np.compute_scales_np):
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

namespace {

constexpr int kRows = 4;         // rows of its range a warp loads before it sums them
constexpr int kFewLeaves = 16;   // at most this many leaves: 512 threads
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

__device__ __forceinline__ void warp_tree(double& amax, double& ss, double& sabs) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double a = __shfl_down_sync(0xffffffffu, amax, off);
    if (a > amax) amax = a;
    ss += __shfl_down_sync(0xffffffffu, ss, off);
    sabs += __shfl_down_sync(0xffffffffu, sabs, off);
  }
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
  __shared__ double s_part[3][kWarps];  // each warp's part of a leaf begun before its range
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
  const int span = (n_slots + kThreads - 1) / kThreads * 32;
  const int wb = min(warp * span, n_slots), we = min(wb + span, n_slots);
  const int rows = (we - wb + 31) / 32;
  double a[kRows], q[kRows], b[kRows];
#pragma unroll
  for (int j = 0; j < kRows; j++) {
    const int t = wb + 32 * j + lane;
    a[j] = t < we ? partials[t] : 0.0;
    q[j] = t < we ? partials[n_slots + t] : 0.0;
    b[j] = t < we ? partials[2 * n_slots + t] : 0.0;
  }
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
  double* sums = staged ? &s_sums[0][0] : leaf_sums;
  const int stride = staged ? kSharedLeaves : n_leaves;

  // the warp's range, row by row; each lane sums its slots of the open
  // leaf in turn; a leaf that ends in a row is closed by the warp's tree:
  // the range's first part of a leaf begun before it to s_part, any other
  // part (a whole leaf, or a leaf's first part) to sums
  if (wb < we) {
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
      if (p1 - p0 == 1) {  // one slot: its lane holds the part, every other lane 0
        if (lane == (p0 - wb) % 32) {
          if (lo < wb) {
            s_part[0][warp] = am;
            s_part[1][warp] = ss;
            s_part[2][warp] = sa;
          } else {
            sums[l] = am;
            sums[stride + l] = ss;
            sums[2 * stride + l] = sa;
          }
        }
      } else {
        warp_tree(am, ss, sa);
        if (lane == 0) {
          if (lo < wb) {
            s_part[0][warp] = am;
            s_part[1][warp] = ss;
            s_part[2][warp] = sa;
          } else {
            sums[l] = am;
            sums[stride + l] = ss;
            sums[2 * stride + l] = sa;
          }
        }
      }
      am = ss = sa = 0.0;
    };
    for (int c = 0; c < rows; c += kRows) {
      if (c > 0) {
#pragma unroll
        for (int j = 0; j < kRows; j++) {
          const int t = wb + 32 * (c + j) + lane;
          a[j] = t < we ? partials[t] : 0.0;
          q[j] = t < we ? partials[n_slots + t] : 0.0;
          b[j] = t < we ? partials[2 * n_slots + t] : 0.0;
        }
      }
      if (min(wb + 32 * (c + kRows), we) <= hi) {  // the chunk lies in the open leaf
#pragma unroll
        for (int j = 0; j < kRows; j++) {
          if (a[j] > am) am = a[j];  // a slot past the range holds 0
          ss += q[j];
          sa += b[j];
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
            if (a[j] > am) am = a[j];
            ss += q[j];
            sa += b[j];
          }
          if (hi >= row_end) break;  // the leaf goes on past the row
          close();                   // the leaf ends in the row
          do {
            l++;
            lo = hi;
            hi = bound(l + 1);
          } while (lo == hi);  // a leaf with no slots is the combine's
        }
      }
    }
    close();
  }
  __syncthreads();

  // each leaf over several ranges, a warp's: lane i sums the parts i, i +
  // 32, ... of its list in turn, then the warp's tree; a leaf with no slots is 0
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
      const double x0 = i ? s_part[0][wa + i] : sums[l];
      const double x1 = i ? s_part[1][wa + i] : sums[stride + l];
      const double x2 = i ? s_part[2][wa + i] : sums[2 * stride + l];
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
  __syncthreads();
  if (!per_leaf) {  // warp 0: lane i sums the leaves i, i + 32, ... in turn, then its tree
    if (warp == 0) {
      double am = 0.0, s2 = 0.0, sa = 0.0, n = 0.0;
      for (int l = lane; l < n_leaves; l += 32) {
        if (sums[l] > am) am = sums[l];
        s2 += sums[stride + l];
        sa += sums[2 * stride + l];
        n += staged ? s_ns[l] : ns[l];
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
    __syncthreads();
  }

  int maxd = 1, live_any = 0;
  for (int l = tid; l < n_leaves; l += kThreads) {
    const double am = sums[l];
    const double a = per_leaf ? am : s_all[0];
    const double n = per_leaf ? (staged ? s_ns[l] : ns[l]) : s_all[3];
    float s;
    if (policy == kAbsMean) {
      s = (float)((per_leaf ? sums[2 * stride + l] : s_all[2]) / n);
    } else {
      s = (float)sqrt((per_leaf ? sums[stride + l] : s_all[1]) / n);
      if (policy == kPow2Rms) s = pow2_floor(s);
    }
    if (!(a > 0.0) || !isfinite(s)) s = 0.0f;
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
