// The per-leaf scale pass on Hopper (sm_90a): a table's scales, one a leaf,
// made on the device with no host sync, before each launch of kernel A.
//
// It replaces the per-leaf scales that the JAX package computes in XLA
// before quantize_rows' pallas_call (shared_tensor_tpu/ops/table.py:
// compute_scales, and in the pod tier parallel/ici.py: _leaf_scales with
// its pmax and psum over the shard axis), which the port ran as a chain of
// some 20-30 eager torch launches. It takes the port's rule for scales from
// partials (ops/codec_np.compute_scales_np, as the finish kernel in
// cascade_round.cu and the frame's scale pass in frame_scale.cu do): max |r|
// in f32, sum r^2 and sum |r| in double over each leaf's live lanes (the
// squares of f32 values are exact in double and the sums cannot overflow, so
// there is no normalising pass), then scale_common.cuh's scale_rule.
//
// Input: a flat f32 residual viewed as (rows, 128), 16-byte aligned, and
// each row's live lane count; the lanes past it count as 0 whatever they
// hold. The rows are cut into slots on a grid of 8-row tiles shifted by
// `phase` rows (0..7): slot t holds rows [8t - phase, 8t + 8 - phase) that
// lie in [0, rows). A table's leaves are padded to whole tiles, so with the
// phase of a block's first row in the table (a pod shard's block may start
// mid-tile) every slot lies in one leaf; leaf_slots[l] .. leaf_slots[l + 1]
// are leaf l's slots.
//
// Design: two launches, no atomics, a fixed order, so every run gives the
// same bits and the plain twin (ops/codec_cuda.leaf_scales_plain) repeats
// them:
// 1. partials: a warp a slot, 8 warps a block. Lane i takes float4 unit i
//    of each of the slot's rows in turn (a 512-byte coalesced load a row,
//    all 8 issued before the first sum) and adds its x, y, z, w in order;
//    then warp_tree, and lane 0 writes slot t of partials[3][slots] (max
//    |r|, sum r^2, sum |r|, double).
// 2. finish: one block of 512 threads for a table of at most 16 leaves,
//    else 1024 (ops/codec_cuda.finish_threads): the partials reduced per
//    leaf by scale_common.cuh's block reduction, the finish kernel's
//    (reduce_ranges, combine_ranges), into leaf_sums[3][L]; without
//    per_leaf one sum over the leaves (sum_leaves); then each leaf's scale
//    by scale_rule into scales[L].
// The finish alone (st_leaf_scales with no residual) takes leaf_sums as
// given, as the pod tier needs once it has summed each block's sums over
// the shard group (a sum of the blocks' maxima is still above 0 exactly
// where their max is, which is all the rule asks of max |r|).
//
// Bound: memory, 4 B an element read once and 24 B a tile written (the
// finish reads those back; one block: latency). Built without fast-math and
// without FTZ: subnormals are kept, double division and sqrt are IEEE.
// rows and slots are below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scale_common.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kPartialWarps = 8;  // slots a block of the partials
constexpr int kFewLeaves = 16;    // at most this many leaves: a 512-thread finish

__global__ void __launch_bounds__(kPartialWarps * 32)
leaf_partials_kernel(const float4* __restrict__ r, const int* __restrict__ rowcount, int rows, int phase,
                     double* __restrict__ partials, int slots) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kPartialWarps + (threadIdx.x >> 5);
  if (t >= slots) return;  // a whole warp: no barrier below
  const int r0 = t * kTileRows - phase;
  float4 v[kTileRows];
  int live[kTileRows];
#pragma unroll
  for (int j = 0; j < kTileRows; j++) {
    const int row = r0 + j;
    const bool in = row >= 0 && row < rows;
    v[j] = in ? r[(long long)row * 32 + lane] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    live[j] = in ? rowcount[row] - 4 * lane : 0;  // this lane's live elements of the row, if positive
  }
  float am = 0.0f;
  double ss = 0.0, sa = 0.0;
#pragma unroll
  for (int j = 0; j < kTileRows; j++) {
    const float x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int c = 0; c < 4; c++) {
      const float e = c < live[j] ? x[c] : 0.0f;  // a dead lane adds nothing
      const float a = fabsf(e);
      if (a > am) am = a;  // a NaN never wins
      const double d = (double)e;
      ss += d * d;  // exact in double: fused or not, one rounding
      sa += (double)a;
    }
  }
  double amd = (double)am;
  st_scale::warp_tree(amd, ss, sa);
  if (lane == 0) {
    partials[t] = amd;
    partials[slots + t] = ss;
    partials[2 * slots + t] = sa;
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
leaf_finish_kernel(const double* __restrict__ partials, const long long* __restrict__ leaf_slots,
                   const double* __restrict__ ns, double* __restrict__ leaf_sums, float* __restrict__ scales,
                   int n_slots, int n_leaves, int policy, int per_leaf, int reduce) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kSharedLeaves = kThreads - 1;  // leaves whose bounds and sums stay in shared memory
  __shared__ double s_all[4];  // max |r|, sum r^2, sum |r|, n over every leaf
  __shared__ int s_bounds[kSharedLeaves + 1];
  __shared__ double s_sums[3][kSharedLeaves];
  __shared__ double s_part[3 * kWarps];  // each warp's part of a leaf begun before its range
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool staged = reduce && n_leaves <= kSharedLeaves;  // then a thread a leaf at most
  double* sums = staged ? &s_sums[0][0] : leaf_sums;
  const int stride = staged ? kSharedLeaves : n_leaves;
  auto leaf_n = [&](int l) { return ns[l]; };
  if (reduce) {
    // one round trip of memory: the first rows of the warp's range and the
    // leaf bounds, issued before any is used
    const int span = st_scale::range_span<kThreads>(n_slots);
    const int wb = min(warp * span, n_slots), we = min(wb + span, n_slots);
    st_scale::Rows rows0;
    st_scale::load_rows(partials, n_slots, wb, we, 0, lane, rows0);
    if (staged && tid <= n_leaves) s_bounds[tid] = (int)leaf_slots[tid];
    __syncthreads();
    const int* sb = s_bounds;
    auto bound = [&](int l) { return staged ? sb[l] : (int)leaf_slots[l]; };
    st_scale::reduce_ranges<kWarps>(partials, n_slots, n_leaves, wb, we, bound, sums, stride, s_part, rows0);
    __syncthreads();
    st_scale::combine_ranges<kWarps>(n_leaves, span, bound, sums, stride, s_part);
    __syncthreads();
  }
  if (!per_leaf) {
    if (warp == 0) st_scale::sum_leaves(n_leaves, sums, stride, leaf_n, s_all);
    __syncthreads();
  }
  for (int l = tid; l < n_leaves; l += kThreads) {
    const double am = sums[l], ss = sums[stride + l], sa = sums[2 * stride + l];
    scales[l] = per_leaf ? st_scale::scale_rule(am, ss, sa, ns[l], policy)
                         : st_scale::scale_rule(s_all[0], s_all[1], s_all[2], s_all[3], policy);
    if (staged) {
      leaf_sums[l] = am;
      leaf_sums[n_leaves + l] = ss;
      leaf_sums[2 * n_leaves + l] = sa;
    }
  }
}

int launch_finish(const double* partials, const long long* leaf_slots, const double* ns, double* leaf_sums,
                  float* scales, int n_slots, int n_leaves, int policy, int per_leaf, int reduce,
                  cudaStream_t s) {
  if (n_leaves <= kFewLeaves)
    leaf_finish_kernel<512><<<1, 512, 0, s>>>(partials, leaf_slots, ns, leaf_sums, scales, n_slots, n_leaves,
                                              policy, per_leaf, reduce);
  else
    leaf_finish_kernel<1024><<<1, 1024, 0, s>>>(partials, leaf_slots, ns, leaf_sums, scales, n_slots, n_leaves,
                                                policy, per_leaf, reduce);
  return (int)cudaGetLastError();
}

}  // namespace

// resid 16-byte aligned, rows x 128 f32; rowcount int32[rows]; phase 0..7;
// partials f64[3][slots] with slots = (rows + phase + 7) / 8; leaf_slots
// int64[L + 1] from 0 to slots; ns f64[L] (live elements); leaf_sums
// f64[3][L] and scales f32[L] written; policy 0 POW2_RMS, 1 RMS, 2 ABS_MEAN.
// With resid null the finish's rule alone, one launch, on leaf_sums as
// given (a pod block's, summed over its shard group): rowcount, rows,
// phase, partials, slots and leaf_slots are not read.
extern "C" int st_leaf_scales(const float* resid, const int* rowcount, long long rows, int phase,
                              double* partials, long long slots, const long long* leaf_slots, const double* ns,
                              double* leaf_sums, float* scales, int n_leaves, int policy, int per_leaf,
                              void* stream) {
  if (n_leaves <= 0 || policy < 0 || policy > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (resid == nullptr)
    return launch_finish(nullptr, nullptr, ns, leaf_sums, scales, 0, n_leaves, policy, per_leaf, 0, s);
  if (rows <= 0 || rows >= (1LL << 31) || phase < 0 || phase >= kTileRows ||
      slots != (rows + phase + kTileRows - 1) / kTileRows)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (slots + kPartialWarps - 1) / kPartialWarps;
  leaf_partials_kernel<<<(unsigned)blocks, kPartialWarps * 32, 0, s>>>(
      reinterpret_cast<const float4*>(resid), rowcount, (int)rows, phase, partials, (int)slots);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(partials, leaf_slots, ns, leaf_sums, scales, (int)slots, n_leaves, policy, per_leaf, 1, s);
}
