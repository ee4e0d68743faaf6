// The conservative slab test that gates a cluster of primitives, shared by
// the clustered megakernel (K3, K3t in megakernel_clustered.cu) and the
// clustered closest hit (K5 in intersect.cu).
//
// A box is a row of 8 floats: mnx mny mnz mxx mxy mxz pad pad.  The test
// is the min/max slab form of geometry/aabb.py::aabb_hit against [t_min,
// bound], with two changes that keep a per-ray gate from culling a hit that
// an ungated sweep would find:
//  - near and far are widened by a few ulp (the TPU kernels' constants), so
//    a primitive lying on a box face, hit at the box's own near or far
//    distance, is never culled by rounding;
//  - a NaN interval passes: with a zero direction component 1/d is inf, and
//    an origin on that slab plane gives 0 * inf = NaN.  The TPU kernels gate
//    a tile of rays at once and any other ray of the tile opens the box; a
//    per-ray gate has no other ray to do so.  fminf and fmaxf drop NaN, so
//    the minima and maxima here are written out.
#pragma once

#include <cuda_runtime.h>

namespace frt {

constexpr float kNearScale = 1.0f - 4e-6f;
constexpr float kFarScale = 1.0f + 4e-6f;
constexpr float kPad = 1e-6f;

// Minimum and maximum that return NaN when either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// True unless the ray o + t d, with inverse direction iv, surely misses the
// box `b` for t in [t_min, bound].
__device__ __forceinline__ bool slab_gate(const float* __restrict__ b,
                                          float ox, float oy, float oz,
                                          float ivx, float ivy, float ivz,
                                          float t_min, float bound) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float t0x = (lo.x - ox) * ivx, t1x = (lo.w - ox) * ivx;
  const float t0y = (lo.y - oy) * ivy, t1y = (hi.x - oy) * ivy;
  const float t0z = (lo.z - oz) * ivz, t1z = (hi.y - oz) * ivz;
  float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                       nan_min(t0z, t1z));
  float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                      nan_max(t0z, t1z));
  near = near * kNearScale - kPad;
  far = far * kFarScale + kPad;
  return !(nan_max(near, t_min) > nan_min(far, bound));
}

}  // namespace frt
