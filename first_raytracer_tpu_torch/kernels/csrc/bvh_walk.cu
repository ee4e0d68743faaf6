// K6 on Hopper: the closest hit of a batch of rays through the flat BVH of
// accel/build.py, the intersector that render/integrator.py's
// default_intersect picks for a FlatBVH.
//
// K6 (`bvh_walk_kernel`) is the device form of the JAX package's
// lax.while_loop in first_raytracer_tpu/accel/traverse.py:64-109, which had
// no Pallas kernel: XLA ran the loop on the TPU.  The port's plain version
// (accel/traverse.py::intersect_bvh_plain) walks every ray in lockstep, one
// step a round of small launches and a host read of "any ray still walking".
// Here each lane of a warp walks one ray, start to end, with no host read:
//  - the nodes are the preorder array with skip links, so the walk needs
//    no stack: a box hit on an inner node steps to node + 1 (its left
//    child), a box miss or a finished leaf jumps to skip[node];
//  - the box test is the slab test of geometry/aabb.py::aabb_hit against
//    (t_min, t_best): t0 = (min - o) * inv_d, t1 = (max - o) * inv_d, minima
//    and maxima that propagate NaN, hit iff max3(near) max t_min <= min3(far)
//    min t_best, so a NaN interval (an origin on a slab plane of an axis the
//    ray does not move along: 0 * inf) misses.  This is not slab.cuh's gate,
//    which widens the interval and lets a NaN interval pass;
//  - a leaf tests its slots k < min(count, max_leaf), slot min(first + k,
//    Np - 1) of prim_ids, with the float32 oc-form sphere test of
//    geometry/sphere.py (a float32 root, not the megakernels' float64 one)
//    or the Moller-Trumbore of geometry/triangle.py (a mixed scene picks by
//    id < Ns), and a slot replaces the winner only at a strictly smaller t.
// So each ray visits the plain walk's nodes and leaf slots in the plain
// walk's order and finds its winner: (prim, t) bit-equal, t = 1e30 and
// prim 0 on a miss.  Counters (optional, one row of 3 int32 a ray): nodes
// whose box was tested, sphere slots and triangle slots tested, as the
// plain walk counts them, and the work that utils/roofline.py counts for
// the bound.
//
// What bounds it on an H100: not bytes or operations (its bound is ~10x
// below it, PERF.md).  A one-thread-a-ray walk (0.017 ms at 2^17
// camera rays of the final scene) was taken to wait on each ray's chain of
// dependent loads, ~20 node steps and ~4 leaf slots a camera ray; measured
// (probes/k6_grid.py), the walk is bound by the instructions its warps
// issue: moving the loads to shared memory bought 9-14%, one instruction a
// NaN minimum 24%, fewer votes 18%.  The design:
//  - a node is one 32-byte record, {min.xyz, skip} and {max.xyz, word}
//    with word = count << 24 | first (accel/build.py::pack_nodes, which
//    checks the ranges on the host), so a node step is two 128-bit loads;
//  - the shared-memory path: when the records and the leaf slots' primitives
//    fit the caller's budget (accel/traverse.py::SHARED_BUDGET), each block
//    stages them at its start: the records by cp.async, the primitives in
//    leaf-slot order gathered from the scene's tensors at every launch (a
//    sphere {c.xyz, r}; a triangle {v0.xyz, id}, {e1}, {e2}, the edges
//    rounded once as triangle_t rounds them; a sphere of a mixed scene
//    {c.xyz, id}, {r}), so a leaf slot is one shared load and the walk
//    never reads prim_ids until the winner's id;
//  - otherwise the global path: the same walk over the records with
//    read-only 128-bit loads, each slot's primitive through prim_ids;
//  - the grid is persistent (as many blocks as the card holds at once, but
//    no more than the rays need), its warps striding over the rays 32 at a
//    time, so a block stages once for many rays;
//  - the warp converges around leaves (Aila and Laine's while-while): its
//    lanes step through inner and missed nodes, up to kNodeSteps between
//    two votes, until each has a leaf pending or is done (kLeafAll; with it
//    false, until one has), then the warp tests its pending leaves
//    together.  A lane never steps past a leaf it has not tested, so the
//    order of its box tests and slots is the plain walk's.  Every loop test
//    is a warp vote, so the lanes meet at each collective.
// The constants are probes/k6_grid.py's measured choice.
//
// Bit-equality also needs each operation rounded as torch rounds it.  The
// plain walk's dot products are torch.sum over a contiguous (R, 3) tensor,
// which sums (x + y) + z on the CPU and (x + z) + y on the card (its
// reduction gives a row of 3 to two lanes, elements 0 and 2 to the first);
// its cross products are torch.linalg.cross, which contracts a*b - c*d into
// fma(a, b, -(c*d)) on both (probes/torch_arith.py counts both on 2^20 rows).
// dot3 and cross_x follow; every other operation is a single rounding, and
// the file is built with --fmad=false like the other kernels.  The plain
// walk divides 1 / d as torch.reciprocal, an IEEE division; so does the
// kernel.  The box's minima and maxima are PTX min.NaN / max.NaN on the card
// (one instruction each): only comparisons read them, and a zero's sign
// does not change a comparison.
#include <cuda_runtime.h>

#include <cmath>

#include "cp_async.cuh"

namespace {

constexpr int kWalkThreads = 512;
constexpr int kWarpSize = 32;
constexpr int kWalkWarps = kWalkThreads / kWarpSize;
constexpr unsigned kFullMask = 0xffffffffu;
// The warp leaves its node phase when every lane has a leaf pending or is
// done (true), or as soon as one lane has a leaf pending (false).
constexpr bool kLeafAll = true;
// Node steps a lane takes between two of the warp's votes.
constexpr int kNodeSteps = 6;
constexpr float kBig = 1e30f;
constexpr float kDetEps = 1e-9f;
// A node record's word: the leaf's count in its top 8 bits, its first slot
// in the low 24.
constexpr int kCountShift = 24;
constexpr unsigned kFirstMask = (1u << kCountShift) - 1u;

// Minimum and maximum that return NaN when either operand is NaN (torch's
// minimum and maximum; fminf and fmaxf drop the NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a < b || a != a) ? a : b;
#endif
}
__device__ __forceinline__ float nan_max(float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a > b || a != a) ? a : b;
#endif
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
__device__ __forceinline__ V3 xyz(float4 v) { return V3{v.x, v.y, v.z}; }
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
// (t_min, kBig), on the edges e1 = v1 - v0 and e2 = v2 - v0.
__device__ __forceinline__ float triangle_t(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                            float t_min) {
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
  const float4* nodes;   // (n_nodes, 2) records (accel/build.py::pack_nodes)
  const int* prim_ids;   // (n_prims,)
  int n_nodes, n_prims;
};

struct Prims {
  const float* sph_center;  // (ns, 3)
  const float* sph_radius;  // (ns,)
  const float* tri_v0;      // (nt, 3)
  const float* tri_v1;
  const float* tri_v2;
  int ns, nt;

  // Whether global id `pid` is a sphere.
  __device__ __forceinline__ bool sphere(int pid) const {
    return nt == 0 || (ns > 0 && pid < ns);
  }
  __device__ __forceinline__ int sphere_index(int pid) const {
    return min(max(pid, 0), ns - 1);
  }
  __device__ __forceinline__ int triangle_index(int pid) const {
    return min(max(ns > 0 ? pid - ns : pid, 0), nt - 1);
  }
};

// The walk's counters: nodes tested, sphere and triangle slots tested.
struct Tally {
  int nodes = 0, spheres = 0, triangles = 0;
};

// How a leaf slot's primitive is found.  Each policy's `test` returns the
// slot's t and the id the winner keeps; `resolve` turns a kept id into the
// global primitive id.
//
// The global path: the slot's id through prim_ids, then the scene.
struct GlobalLeaves {
  static constexpr bool kShared = false;
  Bvh bvh;
  Prims sc;

  __device__ __forceinline__ float test(int slot, V3 o, V3 d, float t_min,
                                        int& keep, Tally& n) const {
    const int pid = __ldg(bvh.prim_ids + slot);
    keep = pid;
    if (sc.sphere(pid)) {
      const int si = sc.sphere_index(pid);
      ++n.spheres;
      return sphere_t(o, d, load3(sc.sph_center, si),
                      __ldg(sc.sph_radius + si), t_min);
    }
    const int ti = sc.triangle_index(pid);
    const V3 v0 = load3(sc.tri_v0, ti);
    ++n.triangles;
    return triangle_t(o, d, v0, sub(load3(sc.tri_v1, ti), v0),
                      sub(load3(sc.tri_v2, ti), v0), t_min);
  }
  __device__ __forceinline__ int resolve(int keep) const { return keep; }
};

// The shared-memory path of a scene without triangles: a slot is {c, r};
// the winner keeps its slot, whose id is read once at the end.
struct SharedSpheres {
  static constexpr bool kShared = true;
  static constexpr int kVecs = 1;
  Bvh bvh;
  Prims sc;
  const float4* rec;

  __device__ static void stage(const Bvh& bvh, const Prims& sc,
                               float4* out) {
    for (int s = threadIdx.x; s < bvh.n_prims; s += kWalkThreads) {
      const int si = sc.sphere_index(__ldg(bvh.prim_ids + s));
      const V3 c = load3(sc.sph_center, si);
      out[s] = make_float4(c.x, c.y, c.z, __ldg(sc.sph_radius + si));
    }
  }
  __device__ __forceinline__ float test(int slot, V3 o, V3 d, float t_min,
                                        int& keep, Tally& n) const {
    const float4 s = rec[slot];
    keep = slot;
    ++n.spheres;
    return sphere_t(o, d, xyz(s), s.w, t_min);
  }
  __device__ __forceinline__ int resolve(int keep) const {
    return __ldg(bvh.prim_ids + keep);
  }
};

// The shared-memory path of a scene with triangles: a slot is three
// float4, {v0, id}, {e1}, {e2} for a triangle and {c, id}, {r} for a
// sphere; the winner keeps the id.
struct SharedMixed {
  static constexpr bool kShared = true;
  static constexpr int kVecs = 3;
  Bvh bvh;
  Prims sc;
  const float4* rec;

  __device__ static void stage(const Bvh& bvh, const Prims& sc,
                               float4* out) {
    for (int s = threadIdx.x; s < bvh.n_prims; s += kWalkThreads) {
      const int pid = __ldg(bvh.prim_ids + s);
      const float id = __int_as_float(pid);
      float4* r = out + kVecs * s;
      if (sc.sphere(pid)) {
        const int si = sc.sphere_index(pid);
        const V3 c = load3(sc.sph_center, si);
        r[0] = make_float4(c.x, c.y, c.z, id);
        r[1] = make_float4(__ldg(sc.sph_radius + si), 0.0f, 0.0f, 0.0f);
        r[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const int ti = sc.triangle_index(pid);
        const V3 v0 = load3(sc.tri_v0, ti);
        const V3 e1 = sub(load3(sc.tri_v1, ti), v0);
        const V3 e2 = sub(load3(sc.tri_v2, ti), v0);
        r[0] = make_float4(v0.x, v0.y, v0.z, id);
        r[1] = make_float4(e1.x, e1.y, e1.z, 0.0f);
        r[2] = make_float4(e2.x, e2.y, e2.z, 0.0f);
      }
    }
  }
  __device__ __forceinline__ float test(int slot, V3 o, V3 d, float t_min,
                                        int& keep, Tally& n) const {
    const float4* r = rec + kVecs * slot;
    const float4 a = r[0];
    const int pid = __float_as_int(a.w);
    keep = pid;
    if (sc.sphere(pid)) {
      ++n.spheres;
      return sphere_t(o, d, xyz(a), r[1].x, t_min);
    }
    ++n.triangles;
    return triangle_t(o, d, xyz(a), xyz(r[1]), xyz(r[2]), t_min);
  }
  __device__ __forceinline__ int resolve(int keep) const { return keep; }
};

// aabb_hit of a node record against (t_min, t_max).
__device__ __forceinline__ bool box_hit(float4 lo, float4 hi, V3 o, V3 inv_d,
                                        float t_min, float t_max) {
  const float t0x = (lo.x - o.x) * inv_d.x, t1x = (hi.x - o.x) * inv_d.x;
  const float t0y = (lo.y - o.y) * inv_d.y, t1y = (hi.y - o.y) * inv_d.y;
  const float t0z = (lo.z - o.z) * inv_d.z, t1z = (hi.z - o.z) * inv_d.z;
  const float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                             nan_min(t0z, t1z));
  const float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                            nan_max(t0z, t1z));
  return nan_max(near, t_min) <= nan_min(far, t_max);
}

struct Rays {
  const float* o;  // (num_rays, 3)
  const float* d;
  int num_rays;
  float t_min;
};

struct Out {
  int* prim;
  float* t;
  bool* hit;
  int* counters;  // (num_rays, 3) or null
};

// One warp walks rays [32 chunk, 32 chunk + 32), a lane each; `nodes` is
// the records' copy the block reads (shared or global).  Called by every
// lane of the warp.
template <class Leaves>
__device__ __forceinline__ void walk_chunk(const Leaves& leaves,
                                           const float4* nodes, int chunk,
                                           const Rays& rays, int max_leaf,
                                           const Out& out) {
  const int n_nodes = leaves.bvh.n_nodes;
  const int last_slot = leaves.bvh.n_prims - 1;
  const int ray = chunk * kWarpSize + static_cast<int>(threadIdx.x) %
                                          kWarpSize;
  const bool live = ray < rays.num_rays;
  V3 org{0.0f, 0.0f, 0.0f}, dir{1.0f, 1.0f, 1.0f};
  if (live) {
    org = load3(rays.o, ray);
    dir = load3(rays.d, ray);
  }
  const V3 inv_d{1.0f / dir.x, 1.0f / dir.y, 1.0f / dir.z};
  float t_best = kBig;
  int keep = -1;
  Tally n;
  int node = live ? 0 : n_nodes;
  // A leaf whose box was hit and whose slots are not tested yet: its first
  // slot, its count and where the walk goes after it.
  bool pending = false;
  int first = 0, count = 0, skip = 0;
  while (__any_sync(kFullMask, node < n_nodes)) {
    // The node phase: inner and missed nodes, until the rule holds.
    while (true) {
#pragma unroll
      for (int step = 0; step < kNodeSteps; ++step) {
        if (node >= n_nodes || pending) break;
        ++n.nodes;
        float4 lo, hi;
        if constexpr (Leaves::kShared) {
          lo = nodes[2 * node];
          hi = nodes[2 * node + 1];
        } else {
          lo = __ldg(nodes + 2 * node);
          hi = __ldg(nodes + 2 * node + 1);
        }
        const bool box_ok = box_hit(lo, hi, org, inv_d, rays.t_min, t_best);
        const unsigned word = __float_as_uint(hi.w);
        count = static_cast<int>(word >> kCountShift);
        skip = __float_as_int(lo.w);
        if (box_ok && count > 0) {
          pending = true;
          first = static_cast<int>(word & kFirstMask);
        } else {
          node = box_ok ? node + 1 : skip;
        }
      }
      const unsigned walking =
          __ballot_sync(kFullMask, node < n_nodes && !pending);
      if (walking == 0) break;
      if (!kLeafAll && __any_sync(kFullMask, pending)) break;
    }
    // The leaf phase: every pending leaf's slots, in order.
    if (pending) {
      const int slots = min(count, max_leaf);
      for (int k = 0; k < slots; ++k) {
        int id;
        const float t_k = leaves.test(min(first + k, last_slot), org, dir,
                                      rays.t_min, id, n);
        if (t_k < t_best) {
          t_best = t_k;
          keep = id;
        }
      }
      node = skip;
      pending = false;
    }
  }
  if (!live) return;
  out.prim[ray] = keep < 0 ? 0 : leaves.resolve(keep);
  out.t[ray] = t_best;
  out.hit[ray] = t_best < kBig;
  if (out.counters != nullptr) {
    out.counters[3 * ray] = n.nodes;
    out.counters[3 * ray + 1] = n.spheres;
    out.counters[3 * ray + 2] = n.triangles;
  }
}

// The persistent walk: the block stages the records and slots (shared
// paths), then its warps take chunks of 32 rays, gridDim.x * kWalkWarps
// chunks apart.
template <class Leaves>
__global__ void __launch_bounds__(kWalkThreads)
    bvh_walk_kernel(Rays rays, Bvh bvh, Prims sc, int max_leaf, Out out) {
  extern __shared__ float4 smem[];
  const float4* nodes = bvh.nodes;
  Leaves leaves{bvh, sc};
  if constexpr (Leaves::kShared) {
    for (int i = threadIdx.x; i < 2 * bvh.n_nodes; i += kWalkThreads)
      frt::copy16_async(smem + i, bvh.nodes + i);
    frt::commit_copies();
    float4* rec = smem + 2 * bvh.n_nodes;
    Leaves::stage(bvh, sc, rec);
    frt::wait_copies<0>();
    __syncthreads();
    nodes = smem;
    leaves.rec = rec;
  }
  const int warp = static_cast<int>(threadIdx.x) / kWarpSize;
  const int stride = static_cast<int>(gridDim.x) * kWalkWarps;
  for (int chunk = static_cast<int>(blockIdx.x) * kWalkWarps + warp;
       chunk * kWarpSize < rays.num_rays; chunk += stride)
    walk_chunk(leaves, nodes, chunk, rays, max_leaf, out);
}

// Shared-memory bytes of the shared path: the records and the slots.
int shared_bytes(int n_nodes, int n_prims, int nt) {
  const long long vecs =
      2LL * n_nodes + static_cast<long long>(nt == 0 ? SharedSpheres::kVecs
                                                     : SharedMixed::kVecs) *
                          n_prims;
  const long long bytes = 16 * vecs;
  return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

template <class Leaves>
int launch(const Rays& rays, const Bvh& bvh, const Prims& sc, int max_leaf,
           const Out& out, int smem, cudaStream_t stream) {
  auto kernel = bvh_walk_kernel<Leaves>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWalkThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = (rays.num_rays + kWalkThreads - 1) / kWalkThreads;
  const int resident = sms * (per_sm > 1 ? per_sm : 1);
  const int blocks = need < resident ? need : resident;
  kernel<<<blocks, kWalkThreads, smem, stream>>>(rays, bvh, sc, max_leaf,
                                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shared-memory bytes K6's shared path stages for a BVH of `n_nodes`
// nodes over `n_prims` slots of a scene with `nt` triangles: 32 a node, 16
// a slot without triangles, 48 with.  K6 takes that path when they are at
// most its `smem_budget`.
int frt_bvh_walk_shared_bytes(int n_nodes, int n_prims, int nt) {
  return shared_bytes(n_nodes, n_prims, nt);
}

// Launches K6 on `stream` over `num_rays` rays (o, d: (num_rays, 3) f32):
// the flat BVH's node records (accel/build.py::FlatBVH.nodes: (n_nodes, 8)
// 32-bit words, 16-byte aligned) and prim_ids ((n_prims,) i32), and the
// scene's spheres (centres (ns, 3), radii (ns,)) and triangles (three
// (nt, 3) vertex arrays), all f32.  The shared-memory path when
// frt_bvh_walk_shared_bytes is at most `smem_budget`, else the global one.
// Writes prim (num_rays,) i32, t (num_rays,) f32, hit (num_rays,) bool and,
// unless `counters` is null, counters (num_rays, 3) i32.  Launches nothing
// for num_rays = 0.  Returns the first CUDA error of the launch's set-up,
// else cudaGetLastError() after it (0 = launched).
int frt_bvh_walk(const float* o, const float* d, const void* nodes,
                 const int* prim_ids, int n_nodes, int n_prims,
                 const float* sph_center, const float* sph_radius, int ns,
                 const float* tri_v0, const float* tri_v1,
                 const float* tri_v2, int nt, int max_leaf, int num_rays,
                 float t_min, int smem_budget, int* prim, float* t,
                 bool* hit, int* counters, void* stream) {
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Rays rays{o, d, num_rays, t_min};
  const Bvh bvh{static_cast<const float4*>(nodes), prim_ids, n_nodes,
                n_prims};
  const Prims sc{sph_center, sph_radius, tri_v0, tri_v1, tri_v2, ns, nt};
  const Out out{prim, t, hit, counters};
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = shared_bytes(n_nodes, n_prims, nt);
  if (smem > smem_budget)
    return launch<GlobalLeaves>(rays, bvh, sc, max_leaf, out, 0, s);
  if (nt == 0)
    return launch<SharedSpheres>(rays, bvh, sc, max_leaf, out, smem, s);
  return launch<SharedMixed>(rays, bvh, sc, max_leaf, out, smem, s);
}

}  // extern "C"
