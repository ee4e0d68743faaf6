// K6 on Hopper: the closest hit of a batch of rays through the flat BVH of
// accel/build.py, the intersector that render/integrator.py's
// default_intersect picks for a FlatBVH.
//
// K6 (`bvh_walk_kernel`) is the device form of the JAX package's
// lax.while_loop in first_raytracer_tpu/accel/traverse.py:64-109, which had
// no Pallas kernel: XLA ran the loop on the TPU.  The port's plain version
// (accel/traverse.py::intersect_bvh_plain) walks every ray in lockstep, one
// step a round of small launches and a host read of "any ray still walking".
// Here one thread walks one ray, start to end, with no host read:
//  - the nodes are the preorder array with skip links, so the walk needs
//    no stack: a box hit on an inner node steps to node + 1 (its left
//    child), a box miss or a finished leaf jumps to skip[node];
//  - the box test is the slab test of geometry/aabb.py::aabb_hit against
//    (t_min, t_best): t0 = (min - o) * inv_d, t1 = (max - o) * inv_d, minima
//    and maxima that propagate NaN, hit iff max3(near) max t_min <= min3(far)
//    min t_best, so a NaN interval (an origin on a slab plane of an axis the
//    ray does not move along: 0 * inf) misses.  This is not slab.cuh's gate,
//    which widens the interval and lets a NaN interval pass;
//  - a leaf tests its slots k < min(count, max_leaf), the primitive id
//    prim_ids[min(first + k, Np - 1)], with the float32 oc-form sphere test
//    of geometry/sphere.py (a float32 root, not the megakernels' float64
//    one) or the Moller-Trumbore of geometry/triangle.py (a mixed scene picks
//    by id < Ns), and a slot replaces the winner only at a strictly smaller
//    t.
// So each ray visits the plain walk's nodes in the plain walk's order and
// finds its winner: (prim, t) bit-equal, t = 1e30 and prim 0 on a miss.
//
// Bit-equality also needs each operation rounded as torch rounds it.  The
// plain walk's dot products are torch.sum over a contiguous (R, 3) tensor,
// which sums (x + y) + z on the CPU and (x + z) + y on the card (its
// reduction gives a row of 3 to two lanes, elements 0 and 2 to the first);
// its cross products are torch.linalg.cross, which contracts a*b - c*d into
// fma(a, b, -(c*d)) on both (probes/torch_arith.py counts both on 2^20 rows).
// dot3 and cross_x follow; every other operation is a single rounding, and
// the file is built with --fmad=false like the other kernels.
//
// The plain walk divides 1 / d as torch.reciprocal, an IEEE division; so
// does the kernel.  Counters (optional, one row of 3 int32 a ray): nodes
// whose box was tested, sphere slots and triangle slots tested: the work
// that utils/roofline.py counts for the bound.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWalkThreads = 128;
constexpr float kBig = 1e30f;
constexpr float kDetEps = 1e-9f;

// Minimum and maximum that return NaN when either operand is NaN (torch's
// minimum and maximum; fminf and fmaxf drop the NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.sum over a row of three, in the order of the device it runs on.
__device__ __forceinline__ float dot3(float x, float y, float z) {
#if defined(__CUDA_ARCH__)
  return (x + z) + y;
#else
  return (x + y) + z;
#endif
}

// One component of torch.linalg.cross: a*b - c*d as fma(a, b, -(c*d)).
__device__ __forceinline__ float cross_x(float a, float b, float c, float d) {
  return fmaf(a, b, -(c * d));
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return dot3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{cross_x(a.y, b.z, a.z, b.y), cross_x(a.z, b.x, a.x, b.z),
            cross_x(a.x, b.y, a.y, b.x)};
}

// geometry/sphere.py::sphere_hit_one against (t_min, kBig): the nearest
// root past t_min, or kBig.
__device__ __forceinline__ float sphere_t(V3 o, V3 d, V3 c, float r,
                                          float t_min) {
  const V3 oc = sub(o, c);
  const float b = dot(oc, d);
  const float cc = dot(oc, oc) - r * r;
  const float disc = b * b - cc;
  const bool has_root = disc > 0.0f;
  const float sq = sqrtf(has_root ? disc : 0.0f);
  const float t_near = -b - sq;
  const float t_far = -b + sq;
  if (has_root && t_near > t_min && t_near < kBig) return t_near;
  if (has_root && t_far > t_min && t_far < kBig) return t_far;
  return kBig;
}

// geometry/triangle.py::triangle_hit_one (Moller-Trumbore) against
// (t_min, kBig).
__device__ __forceinline__ float triangle_t(V3 o, V3 d, V3 v0, V3 v1, V3 v2,
                                            float t_min) {
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  const V3 p = cross(d, e2);
  const float det = dot(e1, p);
  const bool ok = fabsf(det) > kDetEps;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const V3 tv = sub(o, v0);
  const float u = dot(tv, p) * inv_det;
  const V3 q = cross(tv, e1);
  const float v = dot(d, q) * inv_det;
  const float t = dot(e2, q) * inv_det;
  const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > t_min && t < kBig;
  return hit ? t : kBig;
}

struct Bvh {
  const float* node_min;  // (N, 3)
  const float* node_max;  // (N, 3)
  const int* node_first;  // (N,)
  const int* node_count;  // (N,)
  const int* node_skip;   // (N,)
  const int* prim_ids;    // (Np,)
  int n_nodes, n_prims;
};

struct Prims {
  const float* sph_center;  // (Ns, 3)
  const float* sph_radius;  // (Ns,)
  const float* tri_v0;      // (Nt, 3)
  const float* tri_v1;
  const float* tri_v2;
  int ns, nt;
};

// aabb_hit of one node against (t_min, t_max).
__device__ __forceinline__ bool box_hit(const Bvh& bvh, int node, V3 o,
                                        V3 inv_d, float t_min, float t_max) {
  const V3 mn = load3(bvh.node_min, node);
  const V3 mx = load3(bvh.node_max, node);
  const float t0x = (mn.x - o.x) * inv_d.x, t1x = (mx.x - o.x) * inv_d.x;
  const float t0y = (mn.y - o.y) * inv_d.y, t1y = (mx.y - o.y) * inv_d.y;
  const float t0z = (mn.z - o.z) * inv_d.z, t1z = (mx.z - o.z) * inv_d.z;
  const float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                             nan_min(t0z, t1z));
  const float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                            nan_max(t0z, t1z));
  return nan_max(near, t_min) <= nan_min(far, t_max);
}

// One thread walks one ray.  Writes prim, t and hit (t < kBig); counters,
// when not null, as (nodes tested, sphere slots, triangle slots).
__global__ void __launch_bounds__(kWalkThreads)
    bvh_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    Bvh bvh, Prims sc, int max_leaf, int num_rays,
                    float t_min, int* __restrict__ prim,
                    float* __restrict__ t_out, bool* __restrict__ hit,
                    int* __restrict__ counters) {
  const int ray = blockIdx.x * kWalkThreads + threadIdx.x;
  if (ray >= num_rays) return;
  const V3 org = load3(o, ray);
  const V3 dir = load3(d, ray);
  const V3 inv_d{1.0f / dir.x, 1.0f / dir.y, 1.0f / dir.z};
  float t_best = kBig;
  int p_best = 0;
  int nodes = 0, spheres = 0, triangles = 0;
  int node = 0;
  while (node < bvh.n_nodes) {
    ++nodes;
    const bool box_ok = box_hit(bvh, node, org, inv_d, t_min, t_best);
    const int count = __ldg(bvh.node_count + node);
    const bool leaf = count > 0;
    if (box_ok && leaf) {
      const int first = __ldg(bvh.node_first + node);
      const int slots = min(count, max_leaf);
      for (int k = 0; k < slots; ++k) {
        const int pid = __ldg(bvh.prim_ids + min(first + k, bvh.n_prims - 1));
        float t_k;
        if (sc.nt == 0 || (sc.ns > 0 && pid < sc.ns)) {
          const int si = min(max(pid, 0), sc.ns - 1);
          t_k = sphere_t(org, dir, load3(sc.sph_center, si),
                         __ldg(sc.sph_radius + si), t_min);
          ++spheres;
        } else {
          const int ti = min(max(sc.ns > 0 ? pid - sc.ns : pid, 0), sc.nt - 1);
          t_k = triangle_t(org, dir, load3(sc.tri_v0, ti),
                           load3(sc.tri_v1, ti), load3(sc.tri_v2, ti), t_min);
          ++triangles;
        }
        if (t_k < t_best) {
          t_best = t_k;
          p_best = pid;
        }
      }
    }
    node = (box_ok && !leaf) ? node + 1 : __ldg(bvh.node_skip + node);
  }
  prim[ray] = p_best;
  t_out[ray] = t_best;
  hit[ray] = t_best < kBig;
  if (counters != nullptr) {
    counters[3 * ray] = nodes;
    counters[3 * ray + 1] = spheres;
    counters[3 * ray + 2] = triangles;
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream` over `num_rays` rays (o, d: (num_rays, 3) f32):
// the flat BVH's arrays (accel/build.py::FlatBVH: node_min and node_max
// (n_nodes, 3) f32, node_first, node_count and node_skip (n_nodes,) i32,
// prim_ids (n_prims,) i32) and the scene's spheres (centres (ns, 3), radii
// (ns,)) and triangles (three (nt, 3) vertex arrays), all f32.  Writes prim
// (num_rays,) i32, t (num_rays,) f32, hit (num_rays,) bool and, unless
// `counters` is null, counters (num_rays, 3) i32.  Launches nothing for
// num_rays = 0.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_bvh_walk(const float* o, const float* d, const float* node_min,
                 const float* node_max, const int* node_first,
                 const int* node_count, const int* node_skip,
                 const int* prim_ids, int n_nodes, int n_prims,
                 const float* sph_center, const float* sph_radius, int ns,
                 const float* tri_v0, const float* tri_v1,
                 const float* tri_v2, int nt, int max_leaf, int num_rays,
                 float t_min, int* prim, float* t, bool* hit, int* counters,
                 void* stream) {
  if (num_rays > 0) {
    const Bvh bvh{node_min,  node_max, node_first, node_count,
                  node_skip, prim_ids, n_nodes,    n_prims};
    const Prims sc{sph_center, sph_radius, tri_v0, tri_v1, tri_v2, ns, nt};
    const int blocks = (num_rays + kWalkThreads - 1) / kWalkThreads;
    bvh_walk_kernel<<<blocks, kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        o, d, bvh, sc, max_leaf, num_rays, t_min, prim, t, hit, counters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
