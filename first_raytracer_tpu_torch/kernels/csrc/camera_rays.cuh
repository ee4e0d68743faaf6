// The camera ray of one ray id as render/camera.py::generate_rays computes
// it on the camera draw (RNG domain 0), rounded as torch rounds it on the
// device it runs on, and the few reductions that need torch's own order.
// K8 (rng_rays.cu) writes these rays for any ids; K10 and K12's pool mode
// (wavefront_pass.cu) write them for the pool's tail, so they cannot drift
// apart.
//
// Bit-equality with generate_rays as torch runs it: the jitter divided by
// the image size as a true division (vecmath.divide's 0-d tensor, not a
// multiply by the reciprocal), 2 pi rounded to float32 before its multiply,
// sqrtf and the sine and cosine in float32 (one sincosf, which rounds as
// sinf and cosf do), the direction summed in the order camera.py writes it,
// and vecmath.normalize as sum -> 1 / sqrt -> multiply, where torch.sum
// over a row of three adds (x + z) + y on the card and (x + y) + z on the
// CPU (`sum3`; probes/torch_arith.py).  That is not K1's order
// (mega_common.cuh::camera_ray follows the megakernel's), so these rays
// have their own.  A float64 camera takes T = double: the draws and the
// unit disk stay float32 and are promoted as generate_rays promotes them.
// The host build (kernels/host_emu) takes sqrtf, sinf and cosf in double
// rounded once, as core/vecmath.py does on the CPU.
//
// The pixel of an id: every id the callers decode lies in [0, 2^32) (K10
// and K12 clamp theirs into the image, whose largest is 9.6 M rays), and
// there the two floor divisions are unsigned 32-bit ones, each a
// multiply-high by a reciprocal the launcher computes on the host
// (`pixel_decode`), where torch's int64 floor division would be a call of
// the card's 64-bit division routine.  Any other id takes that int64 path,
// behind one compare.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mega_common.cuh"

namespace frt {

// torch.sum over a row of three, in the order of the device it runs on.
template <typename T>
__device__ __forceinline__ T sum3(T x, T y, T z) {
#if defined(__CUDA_ARCH__)
  return (x + z) + y;
#else
  return (x + y) + z;
#endif
}

// The square root in the type's own precision (a bare sqrt of a float
// would take the host's double overload).
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// Python's floor division of int64 by a positive divisor
// (torch.div(..., rounding_mode="floor")).
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The camera's seven fields (render/camera.py::Camera), each its own
// tensor: origin, lower_left, horizontal, vertical, u, v ((3,) each) and
// lens_radius (()).
template <typename T>
struct CameraFields {
  const T* origin;
  const T* lower_left;
  const T* horizontal;
  const T* vertical;
  const T* u;
  const T* v;
  const T* lens_radius;
};

// A 32-bit numerator's floor quotient by a divisor d in [1, 2^32): one
// multiply-high, two shifts and two adds, exact for every numerator
// (Granlund and Montgomery's round-up method with its add step: mul =
// floor(2^32 (2^l - d) / d) + 1, l = ceil(log2 d)).  `fast_div32` makes it
// on the host.
struct FastDiv32 {
  uint32_t mul;
  uint32_t s1;  // min(l, 1)
  uint32_t s2;  // max(l - 1, 0)
};

inline FastDiv32 fast_div32(uint32_t d) {
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint64_t mul = (((uint64_t{1} << l) - d) << 32) / d + 1;
  return FastDiv32{static_cast<uint32_t>(mul), l < 1 ? l : 1u,
                   l > 0 ? l - 1 : 0u};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv32& f) {
  const uint32_t t = __umulhi(n, f.mul);
  return (t + ((n - t) >> f.s1)) >> f.s2;
}

// An nx x ny image at spp samples a pixel, as torch_camera_ray decodes a
// ray id into its pixel: the divisors for the int64 path, the 32-bit
// path's reciprocals and its end (2^32, or 0 where a divisor does not fit
// in 32 bits), and nx and ny as the jitter's divisions take them.
struct PixelDecode {
  int64_t nx, spp;
  uint64_t fast_end;
  FastDiv32 by_spp, by_nx;
  float fnx, fny;
};

inline PixelDecode pixel_decode(int64_t nx, int64_t ny, int64_t spp) {
  constexpr int64_t k32 = int64_t{1} << 32;
  const bool fits = nx < k32 && spp < k32;
  return PixelDecode{nx,
                     spp,
                     fits ? uint64_t{1} << 32 : 0,
                     fast_div32(static_cast<uint32_t>(fits ? spp : 1)),
                     fast_div32(static_cast<uint32_t>(fits ? nx : 1)),
                     static_cast<float>(nx),
                     static_cast<float>(ny)};
}

// Column i and row j of ray `id`'s pixel, as float32.
__device__ __forceinline__ void pixel_of(int64_t id, const PixelDecode& px,
                                         float& fi, float& fj) {
  if (static_cast<uint64_t>(id) < px.fast_end) {
    const uint32_t pixel = divide(static_cast<uint32_t>(id), px.by_spp);
    const uint32_t row = divide(pixel, px.by_nx);
    fi = static_cast<float>(pixel - row * static_cast<uint32_t>(px.nx));
    fj = static_cast<float>(row);
  } else {
    const int64_t pixel = floor_div(id, px.spp);
    const int64_t row = floor_div(pixel, px.nx);
    fi = static_cast<float>(pixel - row * px.nx);
    fj = static_cast<float>(row);
  }
}

// The camera ray through column fi, row fj of an fnx x fny image from the
// ray's four camera draws u: its origin and unit direction.
template <typename T>
__device__ __forceinline__ void camera_ray_at(const float (&u)[4], float fi,
                                              float fj, float fnx, float fny,
                                              const CameraFields<T>& cam,
                                              T (&origin)[3], T (&dir)[3]) {
  const float s = (fi + u[0]) / fnx;
  const float t = (fj + u[1]) / fny;
  // rng.unit_disk_sample in float32, then promoted to the camera's type.
  const float r = sqrtf(u[2]);
  const float theta = kTwoPi * u[3];
  float sin_t, cos_t;
  sincosf(theta, &sin_t, &cos_t);
  const float disk0 = r * cos_t;
  const float disk1 = r * sin_t;
  const T lens = __ldg(cam.lens_radius);
  const T rd0 = lens * static_cast<T>(disk0);
  const T rd1 = lens * static_cast<T>(disk1);
  const T ts = static_cast<T>(s), tt = static_cast<T>(t);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T co = __ldg(cam.origin + c);
    const T offset = rd0 * __ldg(cam.u + c) + rd1 * __ldg(cam.v + c);
    origin[c] = co + offset;
    dir[c] = __ldg(cam.lower_left + c) + ts * __ldg(cam.horizontal + c) +
             tt * __ldg(cam.vertical + c) - co - offset;
  }
  // vecmath.normalize: v * where(n2 > 0, 1 / sqrt(n2), 0).
  const T n2 = sum3(dir[0] * dir[0], dir[1] * dir[1], dir[2] * dir[2]);
  const T inv = n2 > T(0) ? T(1) / root(n2) : T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) dir[c] *= inv;
}

// The camera ray of ray `id` of the image `px` decodes, keyed by (k0, k1):
// its origin and unit direction.
template <typename T>
__device__ __forceinline__ void torch_camera_ray(uint32_t k0, uint32_t k1,
                                                 int64_t id,
                                                 const PixelDecode& px,
                                                 const CameraFields<T>& cam,
                                                 T (&origin)[3],
                                                 T (&dir)[3]) {
  float u[4];
  draws4(k0, k1, static_cast<uint32_t>(id), 0u, u);
  float fi, fj;
  pixel_of(id, px, fi, fj);
  camera_ray_at<T>(u, fi, fj, px.fnx, px.fny, cam, origin, dir);
}

}  // namespace frt
