// The receive-pass design that kernels B (apply_rows.cu) and D
// (apply_frame.cu) share on Hopper (sm_90a). Each of them adds a summed
// sign-frame delta to N target arrays in place, clamped; only how the delta
// is made differs. Their bound is bytes: each target is read and written
// once. What the shared part does about it:
// - Targets by value: the host passes up to kMaxTargets (8) target
//   pointers as one kernel parameter (struct Targets), so they sit in the
//   constant bank from the first instruction and no thread waits on a
//   pointer load before it can load its element. The kernels are templates
//   on N (instantiated by dispatch_targets), so every pointer is read at a
//   fixed offset: indexed by a runtime loop, the struct would be copied to
//   local memory first. More than 8 targets are split by the caller into
//   launches of at most 8.
// - 16-byte lanes, one 128-element row per warp: lane l takes elements
//   4l..4l+3 as one float4 (the 4 bits at (l & 7) * 4 of the row's word
//   l >> 3); N float4s stay in registers. Targets must be 16-byte aligned.
//   The grid has a warp for every row (row_blocks); on the H100 this beat
//   one wave of blocks striding over the rows, for both kernels (PERF.md).
// - Every load before any store: a kernel issues the loads of its frame
//   (words, scales), then load_targets those of all N targets, then makes
//   its delta, and store_targets writes the targets; they may alias as far
//   as the compiler knows, so this order is written out.
// Per element: a = live ? clip(a + delta, -SAT, SAT) : 0. The clip keeps
// NaN as NaN, like jnp.clip, rather than fminf/fmaxf, which would drop it.
// Built without fast-math and without FTZ: subnormals are kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace st_apply {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTargets = 8;
constexpr float kSat = 3.0e38f;

struct Targets {
  float* p[kMaxTargets];
};

__device__ __forceinline__ float clip_sat(float v) {
  if (v != v) return v;  // NaN propagates, as in jnp.clip
  return v < -kSat ? -kSat : (v > kSat ? kSat : v);
}

__device__ __forceinline__ float step(float a, float delta, bool live) {
  return live ? clip_sat(a + delta) : 0.0f;
}

// This lane's 16 bytes at element e of every target.
template <int N>
__device__ __forceinline__ void load_targets(const Targets& t, long long e, float4 (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = *reinterpret_cast<const float4*>(t.p[i] + e);
}

// Writes v + d, clamped, back to every target; of the lane's 4 elements the
// first ``live`` (0..4) are live, the rest become 0.
template <int N>
__device__ __forceinline__ void store_targets(const Targets& t, long long e, const float4 (&v)[N],
                                              float4 d, int live) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float4 o;
    o.x = step(v[i].x, d.x, 0 < live);
    o.y = step(v[i].y, d.y, 1 < live);
    o.z = step(v[i].z, d.z, 2 < live);
    o.w = step(v[i].w, d.w, 3 < live);
    *reinterpret_cast<float4*>(t.p[i] + e) = o;
  }
}

// The grid: a warp for every 128-element row, kWarps rows a block.
inline long long row_blocks(long long rows) { return (rows + kWarps - 1) / kWarps; }

// This warp's row.
__device__ __forceinline__ long long warp_row() {
  return (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// Copies a HOST array of n (1..8) device pointers into a kernel parameter;
// false if n is out of range.
inline bool make_targets(float* const* arrays, int n, Targets* t) {
  if (n < 1 || n > kMaxTargets) return false;
  *t = Targets{};
  for (int i = 0; i < n; ++i) t->p[i] = arrays[i];
  return true;
}

// launch(std::integral_constant<int, N>{}) for N = n, 1 <= n <= 8.
template <class F>
int dispatch_targets(int n, F&& launch) {
  switch (n) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 5: return launch(std::integral_constant<int, 5>{});
    case 6: return launch(std::integral_constant<int, 6>{});
    case 7: return launch(std::integral_constant<int, 7>{});
    default: return launch(std::integral_constant<int, 8>{});
  }
}

}  // namespace st_apply
