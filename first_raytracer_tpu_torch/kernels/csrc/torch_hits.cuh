// The wavefront's ray-primitive arithmetic as torch runs it: three-vectors,
// torch's reductions over a row of three, and the hit distances of
// geometry/sphere.py and geometry/triangle.py, shared by K9, K12 and K13
// (wavefront_pass.cu, the hit re-solved from the winning primitive), K11
// (dense_hit.cu, every pair of the dense sweep) and K14 and K15
// (replay.cu, the tape replay's hit re-solved from its payload row).  Each
// form is a template over the type: float32 for all of them, float64 for
// K14's and K15's float64 instances too.
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

// A three-vector of either precision: float for the float32 kernels (K9,
// K11, K12, K14, K15), double for K14's and K15's float64 instances.
template <class T>
struct Vec3 {
  T x, y, z;
};
using V3 = Vec3<float>;

// The constants torch compares with, as it converts a Python float to the
// tensor's type.
template <class T>
struct Lim;
template <>
struct Lim<float> {
  static constexpr float big = 1e30f;       // geometry/sphere.py::BIG
  static constexpr float det_eps = 1e-9f;   // geometry/triangle.py
  static constexpr float norm_eps = 1e-20f;  // materials/scatter.py
};
template <>
struct Lim<double> {
  static constexpr double big = 1e30;
  static constexpr double det_eps = 1e-9;
  static constexpr double norm_eps = 1e-20;
};

// fma in the type's own precision.
__device__ __forceinline__ float fused(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused(double a, double b, double c) {
  return fma(a, b, c);
}
// |x| in the type's own precision.
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

template <class T>
__device__ __forceinline__ Vec3<T> load3(const T* __restrict__ p,
                                         int64_t i) {
  return Vec3<T>{__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                 __ldg(p + 3 * i + 2)};
}
// A row of a state that the same launch writes: a coherent load.
template <class T>
__device__ __forceinline__ Vec3<T> state3(const T* p, int64_t i) {
  return Vec3<T>{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
template <class T>
__device__ __forceinline__ void store3(T* p, int64_t i, Vec3<T> v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
template <class T>
__device__ __forceinline__ Vec3<T> add(Vec3<T> a, Vec3<T> b) {
  return Vec3<T>{a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ Vec3<T> sub(Vec3<T> a, Vec3<T> b) {
  return Vec3<T>{a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class T>
__device__ __forceinline__ Vec3<T> scale(T s, Vec3<T> v) {
  return Vec3<T>{s * v.x, s * v.y, s * v.z};
}
template <class T>
__device__ __forceinline__ Vec3<T> mul(Vec3<T> a, Vec3<T> b) {
  return Vec3<T>{a.x * b.x, a.y * b.y, a.z * b.z};
}

// vecmath.dot: torch.sum(a * b, dim=-1).
template <class T>
__device__ __forceinline__ T dot(Vec3<T> a, Vec3<T> b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// vecmath.cross: torch.linalg.cross, each component fma(a, b, -(c * d)).
template <class T>
__device__ __forceinline__ Vec3<T> cross(Vec3<T> a, Vec3<T> b) {
  return Vec3<T>{fused(a.y, b.z, -(a.z * b.y)), fused(a.z, b.x, -(a.x * b.z)),
                 fused(a.x, b.y, -(a.y * b.x))};
}

// geometry/sphere.py::_roots with t_max = BIG: the near root, else the far
// one, else BIG.  A NaN fails every comparison and gives BIG.
template <class T>
__device__ __forceinline__ T sphere_roots(T b, T cc, T t_min) {
  const T big = Lim<T>::big;
  const T disc = b * b - cc;
  const bool has = disc > T(0);
  const T sq = root(has ? disc : T(0));
  const T tn = -b - sq;
  const T tf = -b + sq;
  const bool near_ok = has && tn > t_min && tn < big;
  const bool far_ok = has && tf > t_min && tf < big;
  return near_ok ? tn : (far_ok ? tf : big);
}

// The oc form of geometry/sphere.py (sphere_hit_one, sphere_hit_all) on the
// centre and r * r, rounded once.
template <class T>
__device__ __forceinline__ T sphere_t2(Vec3<T> o, Vec3<T> d, Vec3<T> c, T r2,
                                       T t_min) {
  const Vec3<T> oc = sub(o, c);
  const T b = dot(oc, d);
  return sphere_roots(b, dot(oc, oc) - r2, t_min);
}

template <class T>
__device__ __forceinline__ T sphere_t(Vec3<T> o, Vec3<T> d, Vec3<T> c, T r,
                                      T t_min) {
  return sphere_t2(o, d, c, r * r, t_min);
}

// geometry/triangle.py::_moller_trumbore on (v0, e1 = v1 - v0, e2 = v2 -
// v0), BIG on a miss.
template <class T>
__device__ __forceinline__ T triangle_t(Vec3<T> o, Vec3<T> d, Vec3<T> v0,
                                        Vec3<T> e1, Vec3<T> e2, T t_min) {
  const T big = Lim<T>::big;
  const Vec3<T> pvec = cross(d, e2);
  const T det = dot(e1, pvec);
  const bool ok = magnitude(det) > Lim<T>::det_eps;
  const T inv = ok ? T(1) / det : T(0);
  const Vec3<T> tvec = sub(o, v0);
  const T u = dot(tvec, pvec) * inv;
  const Vec3<T> qvec = cross(tvec, e1);
  const T v = dot(d, qvec) * inv;
  const T t = dot(e2, qvec) * inv;
  const bool hit = ok && u >= T(0) && v >= T(0) && u + v <= T(1) &&
                   t > t_min && t < big;
  return hit ? t : big;
}

}  // namespace th
}  // namespace frt
