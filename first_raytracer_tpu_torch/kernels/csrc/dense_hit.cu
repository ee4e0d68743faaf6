// K11 on Hopper: the dense closest hit on the scene's own tensors, the
// wavefront's closest hit without an accel (render/integrator.py::
// default_intersect), so of the gradient step's recorders, the occupancy
// scan, the ring's hops and every wavefront render without an accel.
//
// It is the device form of render/integrator.py::intersect_brute with
// geometry/sphere.py::sphere_hit_all and geometry/triangle.py::
// triangle_hit_all, which replace first_raytracer_tpu/render/integrator.py:
// 106 intersect_brute (geometry/sphere.py:36, geometry/triangle.py:44 there;
// no Pallas kernel: XLA fuses the sweep on the TPU, where torch runs it as
// ~40 ops on (R, N, 3) temporaries).  For every ray, the t of every sphere
// (the oc-form quadratic, near root then far root in (t_min, BIG)) and of
// every triangle (Moller-Trumbore), then torch.argmin over them: the first
// minimum, so the lowest global id wins a tie and a triangle (numbered from
// Ns) displaces a sphere only at a strictly smaller t; all BIG gives prim 0.
// A NaN would count as the minimum, as argmin takes it on the card; none
// arises, since every candidate passes ordered comparisons or is BIG.
// Outputs (prim int32, t float32, hit = t < BIG), each (R,).
//
// Bit-equality with intersect_brute as torch runs it on the same device
// (torch_hits.cuh): the sums over rows of three of the broadcast (R, N, 3)
// products in torch's order for the device, r * r and the edges v1 - v0,
// v2 - v0 rounded once (torch computes them per pair, the same numbers),
// the cross products as torch.linalg.cross, IEEE sqrtf and 1 / det, no
// contraction (--fmad=false), and _roots' branch order.
//
// What bounds it on an H100 (utils/roofline.py): 16 FP32 operations a
// (ray, sphere) pair and 46 a (ray, triangle) pair, against 24 bytes read
// and 9 written a ray: bound by operations.  One thread a ray; the block
// stages the scene's rows through shared memory in tiles, read from the
// scene's tensors at every launch (no pack: a scene moved in place is read
// anew, also under a CUDA graph), rewritten as (cx, cy, cz, r * r) and (v0,
// e1, e2), so a pair reads one 16-byte broadcast (three for a triangle).
// The root's square root runs only for a positive discriminant.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "torch_hits.cuh"

namespace {

using namespace frt::th;
using frt::kBig;

constexpr int kThreads = 128;
constexpr int kSphereTile = 512;    // spheres a tile (8 KB)
constexpr int kTriangleTile = 256;  // triangles a tile (9 KB)
constexpr int kSharedBytes =
    kSphereTile * sizeof(float4) + kTriangleTile * 3 * sizeof(V3);

// argmin's order: t below the best, or the first NaN.
__device__ __forceinline__ bool before(float t, float best) {
  return t < best || (t != t && best == best);
}

__global__ void __launch_bounds__(kThreads)
    dense_hit_kernel(const float* __restrict__ sph_center,
                     const float* __restrict__ sph_radius,
                     const float* __restrict__ tri_v0,
                     const float* __restrict__ tri_v1,
                     const float* __restrict__ tri_v2, int ns, int nt,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction, int64_t n,
                     float t_min, int* __restrict__ prim_out,
                     float* __restrict__ t_out, uint8_t* __restrict__ hit_out) {
  // The tiles, in dynamic shared memory (so that the host emulation gives
  // each block its own): kSphereTile spheres, then kTriangleTile triangles.
  extern __shared__ float4 dense_shared[];
  float4* sph = dense_shared;
  V3(*tri)[3] = reinterpret_cast<V3(*)[3]>(dense_shared + kSphereTile);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;
  V3 o{}, d{};
  if (live) {
    o = load3(origin, i);
    d = load3(direction, i);
  }
  float best_t = kBig;
  int best = 0;
  for (int base = 0; base < ns; base += kSphereTile) {
    const int count = ns - base < kSphereTile ? ns - base : kSphereTile;
    __syncthreads();  // the last tile's readers are done
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const V3 c = load3(sph_center, base + j);
      const float r = __ldg(sph_radius + base + j);
      sph[j] = make_float4(c.x, c.y, c.z, r * r);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float4 s = sph[j];
      const V3 oc = sub(o, V3{s.x, s.y, s.z});
      const float b = dot(oc, d);
      const float cc = dot(oc, oc) - s.w;
      const float disc = b * b - cc;
      if (disc > 0.0f) {  // else the sphere's t is BIG: never below best
        const float t = sphere_roots(b, cc, t_min);
        if (before(t, best_t)) {
          best_t = t;
          best = base + j;
        }
      }
    }
  }
  for (int base = 0; base < nt; base += kTriangleTile) {
    const int count = nt - base < kTriangleTile ? nt - base : kTriangleTile;
    __syncthreads();
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const V3 v0 = load3(tri_v0, base + j);
      tri[j][0] = v0;
      tri[j][1] = sub(load3(tri_v1, base + j), v0);
      tri[j][2] = sub(load3(tri_v2, base + j), v0);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float t = triangle_t(o, d, tri[j][0], tri[j][1], tri[j][2], t_min);
      if (before(t, best_t)) {
        best_t = t;
        best = ns + base + j;
      }
    }
  }
  if (live) {
    prim_out[i] = best;
    t_out[i] = best_t;
    hit_out[i] = best_t < kBig;
  }
}

}  // namespace

extern "C" {

// Launches K11 on `stream` over n rays (module comment): the scene's
// sph_center (ns, 3), sph_radius (ns,), tri_v0, tri_v1, tri_v2 (nt, 3), all
// float32; the rays' origin and direction (n, 3) float32 and t_min; writes
// prim (n,) int32, t (n,) float32 and hit (n,) bool.  Launches nothing for
// n = 0.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_dense_hit(const float* sph_center, const float* sph_radius,
                  const float* tri_v0, const float* tri_v1,
                  const float* tri_v2, int ns, int nt, const float* origin,
                  const float* direction, int64_t n, float t_min, int* prim,
                  float* t, uint8_t* hit, void* stream) {
  if (n > 0) {
    const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
    dense_hit_kernel<<<blocks, kThreads, kSharedBytes,
                       static_cast<cudaStream_t>(stream)>>>(
        sph_center, sph_radius, tri_v0, tri_v1, tri_v2, ns, nt, origin,
        direction, n, t_min, prim, t, hit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
