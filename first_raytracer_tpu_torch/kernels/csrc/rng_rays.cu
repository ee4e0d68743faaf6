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
// which K10 and K12's pool mode (wavefront_pass.cu) share for the pool's
// fresh rays.
//
// On an H100 both are one wave or less on the main paths (2^17 rays: 512
// blocks of 256, every block resident at once), so a launch takes the
// launch's floor (~0.0014 ms in a CUDA graph) plus each SM's issue of its
// ~1,000 rays.  Their bound is the Threefry's integer operations at the
// INT32 rate (utils/roofline.py counts 164 a draw: 0.00129 ms at 2^17
// rays, above the 24-32 bytes a ray K7 moves and the 32-56 of K8), and K7
// runs at the floor plus that bound (PERF.md section 5).  So the design
// cuts issued instructions: K7 reads the id's and the domain's low words
// only (their high halves never reach a counter) and writes a ray's four
// uniforms as one 16-byte store; K8 decodes the pixel of an id below 2^32
// by two 32-bit multiply-highs (camera_rays.cuh), where torch's int64
// floor divisions called the card's 64-bit division routine (84
// instructions) twice and a 32-bit `/` was no faster, and takes the sine
// and cosine from one range reduction.  One thread a ray, coalesced loads
// and stores, no shared memory: the camera staged in it, the rows staged
// for 16-byte stores, two rays a thread and other block sizes were no
// faster (probes/rng_rays.py --variants).  The file is built with
// --fmad=false like the others.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"

namespace {

using frt::CameraFields;

constexpr int kThreads = 256;

// The low 32-bit word of p[i] (little-endian: the word that comes first).
__device__ __forceinline__ uint32_t low_word(const int64_t* p, int64_t i) {
  return __ldg(reinterpret_cast<const uint32_t*>(p + i));
}

__global__ void __launch_bounds__(kThreads)
    uniforms_kernel(const int64_t* __restrict__ key,
                    const int64_t* __restrict__ ids,
                    const int64_t* __restrict__ domain,
                    int64_t domain_stride, int64_t domain_offset, int64_t n,
                    float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  // Only the low 32 bits of the id and of domain + offset reach the
  // counters (id, 2 dom) and (id, 2 dom + 1).
  uint32_t dom = static_cast<uint32_t>(domain_offset);
  if (domain != nullptr) dom += low_word(domain, i * domain_stride);
  float u[4];
  frt::draws4(low_word(key, 0), low_word(key, 1), low_word(ids, i), dom, u);
  out[i] = make_float4(u[0], u[1], u[2], u[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(const int64_t* __restrict__ key,
                       const int64_t* __restrict__ ids, int64_t n,
                       frt::PixelDecode px, CameraFields<T> cam,
                       T* __restrict__ origin, T* __restrict__ direction) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  T o[3], dir[3];
  frt::torch_camera_ray<T>(low_word(key, 0), low_word(key, 1),
                           __ldg(ids + i), px, cam, o, dir);
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
        key, ids, n, frt::pixel_decode(nx, ny, spp), cam, out_origin,
        out_direction);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: out (n, 4) f32 = the uniforms of ray ids `ids`
// (n,) int64 in domain (domain[i * domain_stride] if `domain` is not null,
// else 0) + domain_offset, keyed by `key` (2,) int64.  Launches nothing for
// n = 0.  `out` is 16-byte aligned (a row is one float4 store).  Returns
// cudaGetLastError() after the launch (0 = launched).
int frt_uniforms(const int64_t* key, const int64_t* ids,
                 const int64_t* domain, int64_t domain_stride,
                 int64_t domain_offset, int64_t n, float* out, void* stream) {
  if (n > 0) {
    uniforms_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        key, ids, domain, domain_stride, domain_offset, n,
        reinterpret_cast<float4*>(out));
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
