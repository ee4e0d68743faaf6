// The camera ray of one ray id as render/camera.py::generate_rays computes
// it on the camera draw (RNG domain 0), rounded as torch rounds it on the
// device it runs on, and the few reductions that need torch's own order.
// K8 (rng_rays.cu) writes these rays for any ids; K10 (wavefront_pass.cu)
// writes them for the pool's tail, so the two cannot drift apart.
//
// Bit-equality with generate_rays as torch runs it: the jitter divided by
// the image size as a true division (vecmath.divide's 0-d tensor, not a
// multiply by the reciprocal), 2 pi rounded to float32 before its multiply,
// sqrtf / sinf / cosf in float32, the direction summed in the order
// camera.py writes it, and vecmath.normalize as sum -> 1 / sqrt ->
// multiply, where torch.sum over a row of three adds (x + z) + y on the
// card and (x + y) + z on the CPU (`sum3`; probes/torch_arith.py).  That
// is not K1's order (mega_common.cuh::camera_ray follows the megakernel's),
// so these rays have their own.  A float64 camera takes T = double: the
// draws and the unit disk stay float32 and are promoted as generate_rays
// promotes them.  The host build (kernels/host_emu) takes sqrtf, sinf and
// cosf in double rounded once, as core/vecmath.py does on the CPU.
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

// The camera ray of ray `id` of an nx x ny image at spp samples a pixel,
// keyed by (k0, k1): its origin and unit direction.
template <typename T>
__device__ __forceinline__ void torch_camera_ray(uint32_t k0, uint32_t k1,
                                                 int64_t id, int64_t nx,
                                                 int64_t ny, int64_t spp,
                                                 const CameraFields<T>& cam,
                                                 T (&origin)[3],
                                                 T (&dir)[3]) {
  float u[4];
  draws4(k0, k1, static_cast<uint32_t>(id), 0u, u);
  const int64_t pixel = floor_div(id, spp);
  const int64_t row = floor_div(pixel, nx);
  const float fi = static_cast<float>(pixel - row * nx);
  const float fj = static_cast<float>(row);
  const float s = (fi + u[0]) / static_cast<float>(nx);
  const float t = (fj + u[1]) / static_cast<float>(ny);
  // rng.unit_disk_sample in float32, then promoted to the camera's type.
  const float r = sqrtf(u[2]);
  const float theta = kTwoPi * u[3];
  const float disk0 = r * cosf(theta);
  const float disk1 = r * sinf(theta);
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

}  // namespace frt
