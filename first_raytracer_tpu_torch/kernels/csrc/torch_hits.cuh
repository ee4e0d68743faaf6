// The wavefront's ray-primitive arithmetic as torch runs it: three-vectors,
// torch's reductions over a row of three, and the hit distances of
// geometry/sphere.py and geometry/triangle.py, shared by K9, K12 and K13
// (wavefront_pass.cu, the hit re-solved from the winning primitive) and K11
// (dense_hit.cu, every pair of the dense sweep).
//
// torch.sum over a row of three adds (x + z) + y on the card and
// (x + y) + z on the CPU (camera_rays.cuh::sum3), for the (R, 3) rows of
// the per-ray forms and the broadcast (R, N, 3) rows of the dense sweep
// alike (probes/torch_arith.py); torch.linalg.cross is fma(a, b, -(c * d))
// on both; 1.0 / x is an IEEE division.  Every other operation is one
// rounding in torch's order; the sources are built with --fmad=false.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"

namespace frt {
namespace th {

constexpr float kDetEps = 1e-9f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
// A row of a state that the same launch writes: a coherent load.
__device__ __forceinline__ V3 state3(const float* p, int64_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 v) {
  return V3{s * v.x, s * v.y, s * v.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}

// vecmath.dot: torch.sum(a * b, dim=-1).
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// vecmath.cross: torch.linalg.cross, each component fma(a, b, -(c * d)).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x))};
}

// geometry/sphere.py::_roots with t_max = BIG: the near root, else the far
// one, else kBig.  A NaN fails every comparison and gives kBig.
__device__ __forceinline__ float sphere_roots(float b, float cc,
                                              float t_min) {
  const float disc = b * b - cc;
  const bool has = disc > 0.0f;
  const float sq = sqrtf(has ? disc : 0.0f);
  const float tn = -b - sq;
  const float tf = -b + sq;
  const bool near_ok = has && tn > t_min && tn < kBig;
  const bool far_ok = has && tf > t_min && tf < kBig;
  return near_ok ? tn : (far_ok ? tf : kBig);
}

// The oc form of geometry/sphere.py (sphere_hit_one, sphere_hit_all) on the
// centre and r * r, rounded once.
__device__ __forceinline__ float sphere_t2(V3 o, V3 d, V3 c, float r2,
                                           float t_min) {
  const V3 oc = sub(o, c);
  const float b = dot(oc, d);
  return sphere_roots(b, dot(oc, oc) - r2, t_min);
}

__device__ __forceinline__ float sphere_t(V3 o, V3 d, V3 c, float r,
                                          float t_min) {
  return sphere_t2(o, d, c, r * r, t_min);
}

// geometry/triangle.py::_moller_trumbore on (v0, e1 = v1 - v0, e2 = v2 -
// v0), kBig on a miss.
__device__ __forceinline__ float triangle_t(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                            float t_min) {
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool ok = fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const V3 tvec = sub(o, v0);
  const float u = dot(tvec, pvec) * inv;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv;
  const float t = dot(e2, qvec) * inv;
  const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > t_min && t < kBig;
  return hit ? t : kBig;
}

}  // namespace th
}  // namespace frt
