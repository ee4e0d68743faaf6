// A bounce's shading as torch runs it past the hit: the hit record
// re-solved from the winning primitive's rows, the unit-ball sample of the
// bounce's draw, the material's scatter and the sky.  The forms of
// render/integrator.py::recompute_hit, core/rng.py::unit_ball_sample,
// materials/scatter.py::scatter_from_params, scene/textures.py and
// render/integrator.py::sky_color, shared by K9 and K12
// (wavefront_pass.cu, float32) and K14 and K15 (replay.cu, float32 and
// float64), so that the wavefront's passes and the tape replay cannot
// drift apart.
//
// Each form is a template over the type of the scene's rows and the rays.
// The bounce's uniforms stay float32 whatever the type, as rng.uniforms
// returns them, and so does the ball made from them: a float64 replay
// promotes the ball and the coin where torch promotes them.  Rounding as in
// torch_hits.cuh: torch.prod over a row of three multiplies (x * z) * y on
// the card and (x * y) * z on the CPU; (p - c) / r, 1 / x and (1 - n) /
// (1 + n) are IEEE divisions; x ** 5 is pow(x, 5); the ball's cube root is
// the float64 pow(u, 1/3) rounded to float32; every other operation is one
// rounding in torch's order (the sources are built with --fmad=false).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"
#include "torch_hits.cuh"

namespace frt {
namespace th {

constexpr int kMetal = 1;       // scene/soa.py::MAT_METAL
constexpr int kDielectric = 2;  // scene/soa.py::MAT_DIELECTRIC
constexpr int kChecker = 1;     // scene/soa.py::TEX_CHECKER

// sin and x ** 5 in the type's own precision.
__device__ __forceinline__ float sine(float x) { return sinf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float pow5(float x) { return powf(x, 5.0f); }
__device__ __forceinline__ double pow5(double x) { return pow(x, 5.0); }

// torch.prod over a row of three, in the order of the device it runs on.
template <class T>
__device__ __forceinline__ T prod3(T x, T y, T z) {
#if defined(__CUDA_ARCH__)
  return (x * z) * y;
#else
  return (x * y) * z;
#endif
}

// vecmath.normalize(v, eps): the squared length floored at eps (a NaN
// kept), then v * (1 / sqrt(n2)) where n2 > 0, else 0.
template <class T>
__device__ __forceinline__ Vec3<T> normalize(Vec3<T> v, T eps) {
  T n2 = dot(v, v);
  if (eps > T(0)) n2 = n2 < eps ? eps : n2;
  const T inv = n2 > T(0) ? T(1) / root(n2) : T(0);
  return scale(inv, v);
}

// core/rng.py::unit_ball_sample of the bounce's first three uniforms, in
// float32.
__device__ __forceinline__ V3 ball_sample(const float (&u)[4]) {
  const float z = 1.0f - 2.0f * u[0];
  const float rr = 1.0f - z * z;
  const float r = sqrtf(rr < 0.0f ? 0.0f : rr);
  const float phi = frt::kTwoPi * u[1];
  const float radius = static_cast<float>(
      pow(static_cast<double>(u[2]), 1.0 / 3.0));
  return V3{radius * (r * cosf(phi)), radius * (r * sinf(phi)), radius * z};
}

template <class T>
__device__ __forceinline__ Vec3<T> widen(V3 v) {
  return Vec3<T>{static_cast<T>(v.x), static_cast<T>(v.y),
                 static_cast<T>(v.z)};
}

// The winning primitive's geometry: a sphere's centre and radius in a and
// r, or a triangle's three vertices.
template <class T>
struct Geom {
  bool sphere;
  Vec3<T> a, b, c;
  T r;
};

// The hit record render/integrator.py::recompute_hit re-solves: t (BIG on a
// miss), the point o + t d and the normal, (p - c) / r for a sphere and
// the normalised cross of the edges for a triangle.
template <class T>
struct Surface {
  T t;
  Vec3<T> p, n;
};

template <class T>
__device__ __forceinline__ Surface<T> recompute(const Geom<T>& g, Vec3<T> o,
                                                Vec3<T> d, T t_min) {
  Surface<T> s;
  if (g.sphere) {
    s.t = sphere_t(o, d, g.a, g.r, t_min);
    s.p = add(o, scale(s.t, d));
    const Vec3<T> pc = sub(s.p, g.a);
    s.n = Vec3<T>{pc.x / g.r, pc.y / g.r, pc.z / g.r};
  } else {
    const Vec3<T> e1 = sub(g.b, g.a);
    const Vec3<T> e2 = sub(g.c, g.a);
    s.t = triangle_t(o, d, g.a, e1, e2, t_min);
    s.p = add(o, scale(s.t, d));
    s.n = normalize(cross(e1, e2), T(0));
  }
  return s;
}

// A material's row (materials/scatter.py, scene/textures.py).
template <class T>
struct Material {
  int type, tex;
  Vec3<T> albedo, albedo2;
  T tex_scale, fuzz, ref_idx;
};

// The scatter of one hit, and the branches it took (which the replay's
// backward follows).
template <class T>
struct Scattered {
  bool ok;         // false: a metal ray absorbed below its surface
  bool alt;        // the checker's second colour
  bool outside;    // a dielectric left through its surface
  bool reflected;  // a dielectric's coin chose the reflection
  Vec3<T> dir;     // the scattered direction
  Vec3<T> att;     // the attenuation
};

// materials/scatter.py::scatter_from_params, the material's branch only, at
// the (sanitised) hit point p and normal n, with the bounce's ball and coin.
template <class T>
__device__ __forceinline__ Scattered<T> scatter(const Material<T>& mt,
                                                Vec3<T> d, Vec3<T> p,
                                                Vec3<T> n, V3 ball_f,
                                                float coin) {
  const T eps = Lim<T>::norm_eps;
  const Vec3<T> ball = widen<T>(ball_f);
  Scattered<T> s;
  s.alt = s.outside = s.reflected = false;
  if (mt.type == kDielectric) {
    const T ref = mt.ref_idx;
    const T dn = dot(d, n);
    const Vec3<T> reflected = sub(d, scale(T(2) * dn, n));
    const bool outside = dn > T(0);
    const Vec3<T> on = outside ? Vec3<T>{-n.x, -n.y, -n.z} : n;
    const T ni = outside ? ref : T(1) / ref;
    const T cosine = outside ? ref * dn : -dn;
    // vecmath.refract(d, on, ni).
    const Vec3<T> uv = normalize(d, T(0));
    const T dt = dot(uv, on);
    const T disc = T(1) - ni * ni * (T(1) - dt * dt);
    const bool can = disc > T(0);
    const T sq = root(can ? disc : T(0));
    const Vec3<T> refr = can ? sub(scale(ni, sub(uv, scale(dt, on))),
                                   scale(sq, on))
                             : Vec3<T>{T(0), T(0), T(0)};
    // vecmath.schlick(cosine, ref).
    T r0 = (T(1) - ref) / (T(1) + ref);
    r0 = r0 * r0;
    const T one_minus = T(1) - cosine;
    const T prob = can ? r0 + (T(1) - r0) * pow5(one_minus) : T(1);
    s.outside = outside;
    s.reflected = static_cast<T>(coin) < prob;
    s.dir = normalize(s.reflected ? reflected : refr, eps);
    s.att = Vec3<T>{T(1), T(1), T(1)};
    s.ok = true;
    return s;
  }
  // scene/textures.py::texture_from_params.
  Vec3<T> tex = mt.albedo;
  if (mt.tex == kChecker) {
    const T sc = mt.tex_scale;
    const T sines = prod3(sine(sc * p.x), sine(sc * p.y), sine(sc * p.z));
    if (sines < T(0)) {
      tex = mt.albedo2;
      s.alt = true;
    }
  }
  s.att = tex;
  if (mt.type == kMetal) {
    const Vec3<T> reflected = sub(d, scale(T(2) * dot(d, n), n));
    const Vec3<T> raw = add(reflected, scale(mt.fuzz, ball));
    s.ok = dot(raw, n) > T(0);
    s.dir = normalize(raw, eps);
  } else {
    s.ok = true;
    s.dir = normalize(add(n, ball), eps);
  }
  return s;
}

// render/integrator.py::sky_color: white to blue by height (the colours
// float32 constants, promoted in a float64 replay).
template <class T>
__device__ __forceinline__ Vec3<T> sky_color(Vec3<T> d) {
  const T t = T(0.5f) * (d.y + T(1));
  const T w = T(1) - t;
  return Vec3<T>{w * T(1.0f) + t * T(0.5f), w * T(1.0f) + t * T(0.7f),
                 w * T(1.0f) + t * T(1.0f)};
}

// The sky times the throughput: a ray's radiance where it misses.
template <class T>
__device__ __forceinline__ Vec3<T> sky(Vec3<T> tp, Vec3<T> d) {
  return mul(tp, sky_color(d));
}

}  // namespace th
}  // namespace frt
