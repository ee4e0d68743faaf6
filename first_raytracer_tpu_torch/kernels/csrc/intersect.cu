// K4 and K5 on Hopper: the closest hit of a batch of rays, the pluggable
// intersector of the wavefront integrator (render/integrator.py), the
// regenerative pool (render/regenerative.py) and the wavefront recorders
// (diff/replay.py).
//
// K4 (`intersect_dense_kernel`) replaces
// first_raytracer_tpu/kernels/intersect_pallas.py:93 _intersect_kernel.  It
// computes the same thing: for every ray, the nearest hit past t_min among
// every sphere (the oc-form quadratic of geometry/sphere.py) and every
// triangle (Moller-Trumbore, geometry/triangle.py), as (t, prim): t = 1e30
// and prim 0 on a miss; the lowest sphere index wins a tie; triangles are
// numbered from Ns and replace the sphere winner only at a strictly smaller
// t.  One thread per ray loops over the true sphere count, then the true
// triangle count, keeping the first strict minimum: the argmin convention
// of the TPU kernel.
//
// K5 (`intersect_clustered_kernel`) replaces
// first_raytracer_tpu/kernels/intersect_clustered.py:272 _sphere_pass_kernel
// and :313 _tri_pass_kernel, the two passes of the two-level clustered
// closest hit.  The host (kernels/intersect_clustered.py::
// pack_scene_clustered) cuts each primitive type into SAH clusters of at
// most 128 slots, each with a box.  One thread per ray runs the sphere pass
// over the sphere clusters in pack order, then the triangle pass seeded with
// the sphere pass's (t, gid): each cluster's box is slab-tested against the
// ray's current best t (slab.cuh::slab_gate, conservative), and the members
// of every cluster that passes are swept.  Each hit folds into the running
// winner as the lexicographic minimum of (t, global id) (the TPU kernels'
// `_fold`), so the result does not depend on the order of the sweep or on
// which gates fire, and a sphere (ids below Ns) wins a sphere/triangle tie.
// With the conservative gate, K5 picks K4's winner on every ray.
//
// Both kernels compute each (ray, primitive) pair with the operation order
// of the TPU kernels and of the plain versions (kernels/intersect_pallas.py
// and intersect_clustered.py), built with --fmad=false, so the three agree
// bit for bit on t.
//
// The TPU layout is not carried over: no ray tiles of 512 padded with dummy
// rays, no transposed (3, R) ray planes, no sentinel columns (1e30 centres,
// zero triangles) that miss through inf and NaN arithmetic, no C_BLK blocks
// of statically unrolled clusters, no ray-tile gates opened by any ray of
// the tile, and no global ids carried as f32 rows: the kernels loop over
// the true counts and read int32 ids.
//
// What bounds them on an H100: FP32 work, 17 operations per (ray, sphere)
// and 52 per (ray, triangle) tested (the tests below), plus 29 per box for
// K5; the rays, 24 bytes in and 8 out each, are far below that.  Every
// thread of a warp reads the same primitive at the same step, a broadcast
// through the read-only cache.  K5's warp runs the union of its threads'
// gated clusters.  Staging primitives in shared memory and regrouping rays
// are left to later work.
#include "mega_common.cuh"
#include "slab.cuh"

#include <climits>

namespace {

using frt::kBig;
using frt::slab_gate;

constexpr int kThreads = 128;
constexpr int kSlots = 128;  // slots per cluster

// The oc-form sphere test of geometry/sphere.py: the nearest root in
// (t_min, kBig), else kBig.
__device__ __forceinline__ float sphere_oc(float cx, float cy, float cz,
                                           float r, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float t_min) {
  const float ocx = ox - cx;
  const float ocy = oy - cy;
  const float ocz = oz - cz;
  const float b = ocx * dx + ocy * dy + ocz * dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float disc = b * b - c;
  if (!(disc > 0.0f)) return kBig;
  const float sq = sqrtf(disc);
  const float tn = -b - sq;
  if (tn > t_min && tn < kBig) return tn;
  const float tf = -b + sq;
  if (tf > t_min && tf < kBig) return tf;
  return kBig;
}

// Moller-Trumbore on the vertices of row-major plane `v` (v[k * stride] is
// coordinate k of v0, v1, v2 in turn): t in (t_min, kBig), else kBig.
__device__ __forceinline__ float triangle_mt(const float* __restrict__ v,
                                             int stride, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float t_min) {
  const float v0x = __ldg(&v[0 * stride]);
  const float v0y = __ldg(&v[1 * stride]);
  const float v0z = __ldg(&v[2 * stride]);
  const float e1x = __ldg(&v[3 * stride]) - v0x;
  const float e1y = __ldg(&v[4 * stride]) - v0y;
  const float e1z = __ldg(&v[5 * stride]) - v0z;
  const float e2x = __ldg(&v[6 * stride]) - v0x;
  const float e2y = __ldg(&v[7 * stride]) - v0y;
  const float e2z = __ldg(&v[8 * stride]) - v0z;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-9f)) return kBig;
  const float inv = 1.0f / det;
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vv = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool hit = u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > t_min &&
                   t < kBig;
  return hit ? t : kBig;
}

// K4.  sph (8, sp) planes: cx cy cz r; tri (16, tp) planes: v0 v1 v2.
__global__ void __launch_bounds__(kThreads)
    intersect_dense_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ sph, int ns, int sp,
                           const float* __restrict__ tri, int nt, int tp,
                           int num_rays, float t_min, float* __restrict__ t_out,
                           int* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float t_best = kBig;
  int p_best = 0;
  for (int k = 0; k < ns; ++k) {
    const float t = sphere_oc(__ldg(&sph[k]), __ldg(&sph[sp + k]),
                              __ldg(&sph[2 * sp + k]), __ldg(&sph[3 * sp + k]),
                              ox, oy, oz, dx, dy, dz, t_min);
    if (t < t_best) {
      t_best = t;
      p_best = k;
    }
  }
  for (int k = 0; k < nt; ++k) {
    const float t = triangle_mt(tri + k, tp, ox, oy, oz, dx, dy, dz, t_min);
    if (t < t_best) {
      t_best = t;
      p_best = ns + k;
    }
  }
  t_out[i] = t_best;
  prim_out[i] = p_best;
}

// What a ray's clustered sweep did.
struct Counters {
  int clusters = 0;   // clusters swept (spheres and triangles)
  int sph_slots = 0;  // sphere slots tested
  int tri_slots = 0;  // triangle slots tested
  int boxes = 0;      // cluster boxes slab-tested
};

// The lexicographic (t, gid) fold of one hit into the running winner.
__device__ __forceinline__ void fold(float t, int g, float& t_best,
                                     int& g_best) {
  if (t < t_best || (t == t_best && t < kBig && g < g_best)) {
    t_best = t;
    g_best = g;
  }
}

// K5.  Per type: planes (K_pad * rows, 128) f32, cluster k's plane r in row
// k * rows + r (spheres: rows 8, cx cy cz r; triangles: rows 16, v0 v1 v2);
// boxes (K_pad, 8); gids (K_pad, 128) i32; counts (K_pad,) i32, the members
// filling each cluster's first slots; k the true cluster count.
__global__ void __launch_bounds__(kThreads)
    intersect_clustered_kernel(
        const float* __restrict__ o, const float* __restrict__ d,
        const float* __restrict__ sph, const float* __restrict__ sph_box,
        const int* __restrict__ sph_gid, const int* __restrict__ sph_count,
        int ks, const float* __restrict__ tri,
        const float* __restrict__ tri_box, const int* __restrict__ tri_gid,
        const int* __restrict__ tri_count, int kt, int num_rays, float t_min,
        float* __restrict__ t_out, int* __restrict__ prim_out,
        int* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
  float t_best = kBig;
  int g_best = INT_MAX;
  Counters cnt;
  for (int k = 0; k < ks; ++k) {  // the sphere pass
    ++cnt.boxes;
    if (!slab_gate(sph_box + 8 * k, ox, oy, oz, ivx, ivy, ivz, t_min, t_best))
      continue;
    const int m = __ldg(&sph_count[k]);
    ++cnt.clusters;
    cnt.sph_slots += m;
    const float* p = sph + static_cast<size_t>(8 * k) * kSlots;
    for (int j = 0; j < m; ++j) {
      const float t = sphere_oc(__ldg(&p[j]), __ldg(&p[kSlots + j]),
                                __ldg(&p[2 * kSlots + j]),
                                __ldg(&p[3 * kSlots + j]), ox, oy, oz, dx, dy,
                                dz, t_min);
      if (t < kBig) fold(t, __ldg(&sph_gid[k * kSlots + j]), t_best, g_best);
    }
  }
  for (int k = 0; k < kt; ++k) {  // the triangle pass, seeded by the spheres
    ++cnt.boxes;
    if (!slab_gate(tri_box + 8 * k, ox, oy, oz, ivx, ivy, ivz, t_min, t_best))
      continue;
    const int m = __ldg(&tri_count[k]);
    ++cnt.clusters;
    cnt.tri_slots += m;
    const float* p = tri + static_cast<size_t>(16 * k) * kSlots;
    for (int j = 0; j < m; ++j) {
      const float t = triangle_mt(p + j, kSlots, ox, oy, oz, dx, dy, dz,
                                  t_min);
      if (t < kBig) fold(t, __ldg(&tri_gid[k * kSlots + j]), t_best, g_best);
    }
  }
  t_out[i] = t_best;
  prim_out[i] = t_best < kBig ? g_best : 0;
  if (counters != nullptr) {
    int* c = counters + 4 * static_cast<size_t>(i);
    c[0] = cnt.clusters;
    c[1] = cnt.sph_slots;
    c[2] = cnt.tri_slots;
    c[3] = cnt.boxes;
  }
}

}  // namespace

extern "C" {

// Launches K4 on `stream` over `num_rays` rays (o, d: (num_rays, 3) f32);
// writes t (num_rays,) f32 and prim (num_rays,) i32.  The tables are those of
// kernels/intersect_pallas.py::PallasScenePack; `sp`, `tp` their column
// counts.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_intersect_dense(const float* o, const float* d, const float* sph,
                        int ns, int sp, const float* tri, int nt, int tp,
                        int num_rays, float t_min, float* t, int* prim,
                        void* stream) {
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    intersect_dense_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        o, d, sph, ns, sp, tri, nt, tp, num_rays, t_min, t, prim);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K5 (both passes) on `stream`; writes t, prim and, unless
// `counters` is null, counters (num_rays, 4) i32.  The tables are those of
// kernels/intersect_clustered.py::ClusteredScenePack.  Returns
// cudaGetLastError() after the launch.
int frt_intersect_clustered(const float* o, const float* d, const float* sph,
                            const float* sph_box, const int* sph_gid,
                            const int* sph_count, int ks, const float* tri,
                            const float* tri_box, const int* tri_gid,
                            const int* tri_count, int kt, int num_rays,
                            float t_min, float* t, int* prim, int* counters,
                            void* stream) {
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    intersect_clustered_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        o, d, sph, sph_box, sph_gid, sph_count, ks, tri, tri_box, tri_gid,
        tri_count, kt, num_rays, t_min, t, prim, counters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
