// Variants of K7 and K8 (first_raytracer_tpu_torch/kernels/csrc/rng_rays.cu)
// for probes/rng_rays.py --variants, which builds this file with the
// package's nvcc flags and -I the package's csrc, holds every variant
// bit-equal to the package's kernel and times them in turns.
//
// K7 (`k7_variant`, float32 rows of four uniforms):
//   0 shipped: the id's and domain's low words, one float4 store;
//   1 four scalar stores a row;
//   2 the id and the domain read as 8-byte words;
//   3 two rays a thread (i and i + ceil(n / 2)), their Threefry chains
//     interleaved;
//   4, 5 the shipped kernel in blocks of 128 and 512 threads.
// K8 (`k8_variant`, a float32 camera):
//   0 shipped: camera_rays.cuh's torch_camera_ray;
//   1 the pixel decoded by the card's unsigned 32-bit division;
//   2 the pixel decoded by int64 floor divisions (the design before);
//   3 sinf and cosf apart (two range reductions);
//   4 the 19 camera values read once a block into shared memory;
//   5 the block's origin and direction rows staged in shared memory and
//     written as 16-byte vectors;
//   6 the design before: int64 floor divisions and sinf, cosf apart;
//   7 two rays a thread (i and i + ceil(n / 2)), the key and the camera
//     read once for both, their chains interleaved.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"

namespace {

using frt::CameraFields;

__device__ __forceinline__ uint32_t low_word(const int64_t* p, int64_t i) {
  return __ldg(reinterpret_cast<const uint32_t*>(p + i));
}

template <int Threads, int Variant>
__global__ void __launch_bounds__(Threads)
    k7_kernel(const int64_t* __restrict__ key, const int64_t* __restrict__ ids,
              const int64_t* __restrict__ domain, int64_t stride,
              int64_t offset, int64_t n, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * Threads + threadIdx.x;
  const uint32_t k0 = low_word(key, 0), k1 = low_word(key, 1);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (Variant == 3) {
    const int64_t half = (n + 1) / 2;
    if (i >= half) return;
    const int64_t j = i + half;
    const bool second = j < n;
    uint32_t da = static_cast<uint32_t>(offset), db = da;
    if (domain != nullptr) {
      da += low_word(domain, i * stride);
      if (second) db += low_word(domain, j * stride);
    }
    float ua[4], ub[4];
    frt::draws4(k0, k1, low_word(ids, i), da, ua);
    frt::draws4(k0, k1, second ? low_word(ids, j) : 0u, db, ub);
    out4[i] = make_float4(ua[0], ua[1], ua[2], ua[3]);
    if (second) out4[j] = make_float4(ub[0], ub[1], ub[2], ub[3]);
    return;
  }
  if (i >= n) return;
  uint32_t id, dom;
  if (Variant == 2) {
    id = static_cast<uint32_t>(__ldg(ids + i));
    dom = static_cast<uint32_t>(
        (domain != nullptr ? __ldg(domain + i * stride) : 0) + offset);
  } else {
    id = low_word(ids, i);
    dom = static_cast<uint32_t>(offset);
    if (domain != nullptr) dom += low_word(domain, i * stride);
  }
  float u[4];
  frt::draws4(k0, k1, id, dom, u);
  if (Variant == 1) {
    out[4 * i] = u[0];
    out[4 * i + 1] = u[1];
    out[4 * i + 2] = u[2];
    out[4 * i + 3] = u[3];
  } else {
    out4[i] = make_float4(u[0], u[1], u[2], u[3]);
  }
}

template <int Threads, int Variant>
int launch_k7(const int64_t* key, const int64_t* ids, const int64_t* domain,
              int64_t stride, int64_t offset, int64_t n, float* out,
              cudaStream_t stream) {
  const int64_t work = Variant == 3 ? (n + 1) / 2 : n;
  const int blocks = static_cast<int>((work + Threads - 1) / Threads);
  k7_kernel<Threads, Variant><<<blocks, Threads, 0, stream>>>(
      key, ids, domain, stride, offset, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The camera's values through __ldg, or from a block's shared copy.
struct LdgCamera {
  CameraFields<float> f;
  __device__ float origin(int c) const { return __ldg(f.origin + c); }
  __device__ float lower_left(int c) const { return __ldg(f.lower_left + c); }
  __device__ float horizontal(int c) const { return __ldg(f.horizontal + c); }
  __device__ float vertical(int c) const { return __ldg(f.vertical + c); }
  __device__ float u(int c) const { return __ldg(f.u + c); }
  __device__ float v(int c) const { return __ldg(f.v + c); }
  __device__ float lens() const { return __ldg(f.lens_radius); }
};

struct SharedCamera {
  const float* s;  // origin, lower_left, horizontal, vertical, u, v, lens
  __device__ float origin(int c) const { return s[c]; }
  __device__ float lower_left(int c) const { return s[3 + c]; }
  __device__ float horizontal(int c) const { return s[6 + c]; }
  __device__ float vertical(int c) const { return s[9 + c]; }
  __device__ float u(int c) const { return s[12 + c]; }
  __device__ float v(int c) const { return s[15 + c]; }
  __device__ float lens() const { return s[18]; }
};

// camera_rays.cuh's camera_ray_at in float32 over either camera, its sine
// and cosine from one sincosf or apart.
template <bool SinCos, class Cam>
__device__ __forceinline__ void ray_at(const float (&u)[4], float fi, float fj,
                                       float fnx, float fny, const Cam& cam,
                                       float (&origin)[3], float (&dir)[3]) {
  const float s = (fi + u[0]) / fnx;
  const float t = (fj + u[1]) / fny;
  const float r = sqrtf(u[2]);
  const float theta = frt::kTwoPi * u[3];
  float sin_t, cos_t;
  if (SinCos) {
    sincosf(theta, &sin_t, &cos_t);
  } else {
    cos_t = cosf(theta);
    sin_t = sinf(theta);
  }
  const float lens = cam.lens();
  const float rd0 = lens * (r * cos_t);
  const float rd1 = lens * (r * sin_t);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float co = cam.origin(c);
    const float offset = rd0 * cam.u(c) + rd1 * cam.v(c);
    origin[c] = co + offset;
    dir[c] = cam.lower_left(c) + s * cam.horizontal(c) +
             t * cam.vertical(c) - co - offset;
  }
  const float n2 = frt::sum3(dir[0] * dir[0], dir[1] * dir[1],
                             dir[2] * dir[2]);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) dir[c] *= inv;
}

constexpr int kK8Threads = 256;

template <int Variant>
__global__ void __launch_bounds__(kK8Threads)
    k8_kernel(const int64_t* __restrict__ key,
              const int64_t* __restrict__ ids, int64_t n,
              frt::PixelDecode px, CameraFields<float> cam,
              float* __restrict__ origin, float* __restrict__ direction) {
  __shared__ float cam_s[19];
  __shared__ float4 rows[2][kK8Threads * 3 / 4];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kK8Threads;
  const int64_t i = base + threadIdx.x;
  if (Variant == 4) {
    const float* src[7] = {cam.origin, cam.lower_left, cam.horizontal,
                           cam.vertical, cam.u, cam.v, cam.lens_radius};
    if (threadIdx.x < 19) {
      const int t = threadIdx.x;
      cam_s[t] = __ldg(src[t < 18 ? t / 3 : 6] + (t < 18 ? t % 3 : 0));
    }
    __syncthreads();
  }
  if (Variant != 5 && i >= n) return;
  float o[3], d[3];
  if (i < n) {
    const uint32_t k0 = low_word(key, 0), k1 = low_word(key, 1);
    const int64_t id = __ldg(ids + i);
    float u[4];
    frt::draws4(k0, k1, static_cast<uint32_t>(id), 0u, u);
    float fi, fj;
    if (Variant == 1) {
      const uint32_t pixel =
          static_cast<uint32_t>(id) / static_cast<uint32_t>(px.spp);
      const uint32_t row = pixel / static_cast<uint32_t>(px.nx);
      fi = static_cast<float>(pixel - row * static_cast<uint32_t>(px.nx));
      fj = static_cast<float>(row);
    } else if (Variant == 2 || Variant == 6) {
      const int64_t pixel = frt::floor_div(id, px.spp);
      const int64_t row = frt::floor_div(pixel, px.nx);
      fi = static_cast<float>(pixel - row * px.nx);
      fj = static_cast<float>(row);
    } else {
      frt::pixel_of(id, px, fi, fj);
    }
    if (Variant == 3 || Variant == 6) {
      ray_at<false>(u, fi, fj, px.fnx, px.fny, LdgCamera{cam}, o, d);
    } else if (Variant == 4) {
      ray_at<true>(u, fi, fj, px.fnx, px.fny, SharedCamera{cam_s}, o, d);
    } else {
      frt::camera_ray_at<float>(u, fi, fj, px.fnx, px.fny, cam, o, d);
    }
  }
  if (Variant != 5) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      origin[3 * i + c] = o[c];
      direction[3 * i + c] = d[c];
    }
    return;
  }
  float* so = reinterpret_cast<float*>(rows[0]);
  float* sd = reinterpret_cast<float*>(rows[1]);
  if (i < n) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      so[3 * threadIdx.x + c] = o[c];
      sd[3 * threadIdx.x + c] = d[c];
    }
  }
  __syncthreads();
  const int64_t left = n - base;
  if (left >= kK8Threads) {
    float4* go = reinterpret_cast<float4*>(origin + 3 * base);
    float4* gd = reinterpret_cast<float4*>(direction + 3 * base);
    for (int k = threadIdx.x; k < kK8Threads * 3 / 4; k += kK8Threads) {
      go[k] = rows[0][k];
      gd[k] = rows[1][k];
    }
  } else {
    for (int k = threadIdx.x; k < 3 * left; k += kK8Threads) {
      origin[3 * base + k] = so[k];
      direction[3 * base + k] = sd[k];
    }
  }
}

__global__ void __launch_bounds__(kK8Threads)
    k8_two_rays(const int64_t* __restrict__ key,
                const int64_t* __restrict__ ids, int64_t n,
                frt::PixelDecode px, CameraFields<float> cam,
                float* __restrict__ origin, float* __restrict__ direction) {
  const int64_t half = (n + 1) / 2;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kK8Threads +
                    threadIdx.x;
  if (i >= half) return;
  const int64_t j = i + half;
  const bool second = j < n;
  const uint32_t k0 = low_word(key, 0), k1 = low_word(key, 1);
  const int64_t ida = __ldg(ids + i);
  const int64_t idb = second ? __ldg(ids + j) : ida;
  float oa[3], da[3], ob[3], db[3];
  frt::torch_camera_ray<float>(k0, k1, ida, px, cam, oa, da);
  frt::torch_camera_ray<float>(k0, k1, idb, px, cam, ob, db);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    origin[3 * i + c] = oa[c];
    direction[3 * i + c] = da[c];
  }
  if (second) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      origin[3 * j + c] = ob[c];
      direction[3 * j + c] = db[c];
    }
  }
}

template <int Variant>
int launch_k8(const int64_t* key, const int64_t* ids, int64_t n,
              const frt::PixelDecode& px, const CameraFields<float>& cam,
              float* origin, float* direction, cudaStream_t stream) {
  const int blocks = static_cast<int>((n + kK8Threads - 1) / kK8Threads);
  k8_kernel<Variant><<<blocks, kK8Threads, 0, stream>>>(
      key, ids, n, px, cam, origin, direction);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7's variant `which` (file comment) over n ids, as frt_uniforms takes
// them; -1 for an unknown variant.
int k7_variant(int which, const int64_t* key, const int64_t* ids,
               const int64_t* domain, int64_t stride, int64_t offset,
               int64_t n, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: return launch_k7<256, 0>(key, ids, domain, stride, offset, n, out, s);
    case 1: return launch_k7<256, 1>(key, ids, domain, stride, offset, n, out, s);
    case 2: return launch_k7<256, 2>(key, ids, domain, stride, offset, n, out, s);
    case 3: return launch_k7<256, 3>(key, ids, domain, stride, offset, n, out, s);
    case 4: return launch_k7<128, 0>(key, ids, domain, stride, offset, n, out, s);
    case 5: return launch_k7<512, 0>(key, ids, domain, stride, offset, n, out, s);
    default: return -1;
  }
}

// K8's variant `which` (file comment) over n ids of an nx x ny image at
// spp samples a pixel, as frt_camera_rays_f32 takes them.
int k8_variant(int which, const int64_t* key, const int64_t* ids, int64_t n,
               int64_t nx, int64_t ny, int64_t spp, const float* origin,
               const float* lower_left, const float* horizontal,
               const float* vertical, const float* u, const float* v,
               const float* lens_radius, float* out_origin,
               float* out_direction, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CameraFields<float> cam{origin, lower_left, horizontal, vertical,
                                u,      v,          lens_radius};
  const frt::PixelDecode px = frt::pixel_decode(nx, ny, spp);
  switch (which) {
    case 0: return launch_k8<0>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 1: return launch_k8<1>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 2: return launch_k8<2>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 3: return launch_k8<3>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 4: return launch_k8<4>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 5: return launch_k8<5>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 6: return launch_k8<6>(key, ids, n, px, cam, out_origin, out_direction, s);
    case 7: {
      const int64_t half = (n + 1) / 2;
      k8_two_rays<<<static_cast<int>((half + kK8Threads - 1) / kK8Threads),
                    kK8Threads, 0, s>>>(key, ids, n, px, cam, out_origin,
                                        out_direction);
      return static_cast<int>(cudaGetLastError());
    }
    default: return -1;
  }
}

}  // extern "C"
