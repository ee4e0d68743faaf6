// K7 and K8 on Hopper: the wavefront paths' random draws and camera rays.
//
// K7 (`uniforms_kernel`) is the device form of core/rng.py::uniforms_plain:
// the four uniforms of RNG domain `dom` for each ray id, from two
// Threefry-2x32-20 calls with counters (id, 2 dom) and (id, 2 dom + 1).  It
// replaces first_raytracer_tpu/core/rng.py:97-132 (`_uniforms` and its
// callers), which had no Pallas kernel: XLA fused each draw into a few
// loops on the TPU.  The port's plain version runs Threefry as ~350 int64
// torch ops a draw, each a node of the wavefront loops' CUDA graphs
// (render/graphed.py); here one thread draws one ray's four uniforms with
// mega_common.cuh's `draws4`, the same code K1-K3t run inside their paths.
// The work is pure 32-bit integer arithmetic, so K7 is bit-equal to the
// plain version on every device.  The key is read from its (2,) int64
// device tensor on every launch (masked to 32 bits, as
// core/rng.py::_key_schedule masks it), never baked in, so a captured graph
// replays with the key its buffer holds.  The domain is a value, or an
// int64 per ray (stride 1) or shared (stride 0) read through a pointer,
// plus an offset (1 for a bounce: domain 1 + depth); ids are int64 masked
// to 32 bits.
//
// K8 (`camera_rays_kernel<T>`) fuses the camera draw with
// render/camera.py::generate_rays, which replaces
// first_raytracer_tpu/render/camera.py:71 (no Pallas kernel either).  It is
// bit-equal to generate_rays as torch runs it on the same device; the ray's
// arithmetic, torch's rounding and the host build's are camera_rays.cuh's,
// which K10 (wavefront_pass.cu) shares for the pool's fresh rays.
//
// Both are bound by bytes on an H100: K7 reads an 8-byte id (and an 8-byte
// depth when it has one per ray) and writes 16 bytes a ray, against ~250
// integer operations (utils/roofline.py); K8 reads 8 and writes 24 (float32)
// or 48 (float64).  One thread a ray with coalesced loads and stores, no
// shared memory.  The file is built with --fmad=false like the others.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"

namespace {

using frt::CameraFields;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    uniforms_kernel(const int64_t* __restrict__ key,
                    const int64_t* __restrict__ ids,
                    const int64_t* __restrict__ domain,
                    int64_t domain_stride, int64_t domain_offset, int64_t n,
                    float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = static_cast<uint32_t>(__ldg(key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(key + 1));
  const int64_t dom =
      (domain != nullptr ? __ldg(domain + i * domain_stride) : 0) +
      domain_offset;
  float u[4];
  frt::draws4(k0, k1, static_cast<uint32_t>(__ldg(ids + i)),
              static_cast<uint32_t>(dom), u);
  out[4 * i] = u[0];
  out[4 * i + 1] = u[1];
  out[4 * i + 2] = u[2];
  out[4 * i + 3] = u[3];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(const int64_t* __restrict__ key,
                       const int64_t* __restrict__ ids, int64_t n, int64_t nx,
                       int64_t ny, int64_t spp, CameraFields<T> cam,
                       T* __restrict__ origin, T* __restrict__ direction) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  T o[3], dir[3];
  frt::torch_camera_ray<T>(static_cast<uint32_t>(__ldg(key)),
                           static_cast<uint32_t>(__ldg(key + 1)),
                           __ldg(ids + i), nx, ny, spp, cam, o, dir);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    origin[3 * i + c] = o[c];
    direction[3 * i + c] = dir[c];
  }
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_camera_rays(const int64_t* key, const int64_t* ids, int64_t n,
                       int64_t nx, int64_t ny, int64_t spp, const T* origin,
                       const T* lower_left, const T* horizontal,
                       const T* vertical, const T* u, const T* v,
                       const T* lens_radius, T* out_origin,
                       T* out_direction, void* stream) {
  if (n > 0) {
    const CameraFields<T> cam{origin, lower_left, horizontal, vertical,
                              u,      v,          lens_radius};
    camera_rays_kernel<T><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        key, ids, n, nx, ny, spp, cam, out_origin, out_direction);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: out (n, 4) f32 = the uniforms of ray ids `ids`
// (n,) int64 in domain (domain[i * domain_stride] if `domain` is not null,
// else 0) + domain_offset, keyed by `key` (2,) int64.  Launches nothing for
// n = 0.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_uniforms(const int64_t* key, const int64_t* ids,
                 const int64_t* domain, int64_t domain_stride,
                 int64_t domain_offset, int64_t n, float* out, void* stream) {
  if (n > 0) {
    uniforms_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        key, ids, domain, domain_stride, domain_offset, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K8 on `stream`: the camera rays of ray ids `ids` (n,) int64 of an
// nx x ny image at spp samples a pixel, keyed by `key` (2,) int64, from the
// camera's seven fields; writes origin and direction, (n, 3) each, in the
// camera's type (f32 or f64).  Launches nothing for n = 0.  Returns
// cudaGetLastError() after the launch.
int frt_camera_rays_f32(const int64_t* key, const int64_t* ids, int64_t n,
                        int64_t nx, int64_t ny, int64_t spp,
                        const float* origin, const float* lower_left,
                        const float* horizontal, const float* vertical,
                        const float* u, const float* v,
                        const float* lens_radius, float* out_origin,
                        float* out_direction, void* stream) {
  return launch_camera_rays<float>(key, ids, n, nx, ny, spp, origin,
                                   lower_left, horizontal, vertical, u, v,
                                   lens_radius, out_origin, out_direction,
                                   stream);
}

int frt_camera_rays_f64(const int64_t* key, const int64_t* ids, int64_t n,
                        int64_t nx, int64_t ny, int64_t spp,
                        const double* origin, const double* lower_left,
                        const double* horizontal, const double* vertical,
                        const double* u, const double* v,
                        const double* lens_radius, double* out_origin,
                        double* out_direction, void* stream) {
  return launch_camera_rays<double>(key, ids, n, nx, ny, spp, origin,
                                    lower_left, horizontal, vertical, u, v,
                                    lens_radius, out_origin, out_direction,
                                    stream);
}

}  // extern "C"
