// K3 and K3t on Hopper: the clustered megakernel, which renders (K3) or
// records the winner tape of (K3t) scenes far past the dense kernels' sizes.
//
// Both replace first_raytracer_tpu/kernels/megakernel_clustered.py:532
// _mega_clustered_kernel, the Pallas megakernel with gated per-cluster sweeps
// (K3t: the same kernel with emit_tape=True, as
// first_raytracer_tpu/kernels/record_mega.py:673 record_paths_mega_clustered
// launches it).  They compute the same thing as K1 and K2b, the paths of the
// same Threefry stream shaded by the same code (mega_common.cuh::trace_path),
// with the dense sweep replaced by a two-level culled one over the host's SAH
// clusters (kernels/megakernel_clustered.py::pack_scene_mega_clustered):
//
//  - each primitive type is cut into clusters of at most 128 slots, laid out
//    cluster-major (cluster k owns columns 128 k .. 128 k + 127, its members
//    first), and up to 8 clusters share a supergroup box;
//  - per segment the ray walks the sphere supergroups in pack order,
//    slab-tests each supergroup box against its own current best t, then the
//    boxes of the supergroup's clusters, and sweeps the members of every
//    cluster that passes;
//  - the triangles follow, gated by min(sphere best t, triangle best t);
//  - the winner of each type is the lexicographic minimum of (t, column), a
//    sphere wins a sphere/triangle tie, so the result does not depend on the
//    order in which gates fire.  The plain version sweeps every column with no
//    gates and picks the same winner, so it checks the gates.
//
// The slab test stays conservative: near and far are widened by a few ulp, as
// the TPU kernel does, so a knife-edge hit is never culled; a NaN (an origin
// on a slab plane with a zero direction component, 0 * inf) passes the gate,
// since no other lane of a tile opens the cluster for this ray here.
//
// K3 (`mega_clustered_kernel`): one thread per pixel, looping its samples in
// order, writing the pixel's radiance sum, segment count and sweep counters
// (clusters swept, sphere and triangle slots tested, boxes tested).
// K3t (`record_clustered_kernel`): one thread per ray id, K2b's shape: an
// int32 (D, R) tape holding -1 or the original id, every row written, and
// per-ray trip counts and sweep counters.
//
// The TPU schedule is not carried over: no band, stride or rect pixel
// mapping, no flush blocks, no gate words, ctz loop or two rounds, no one-hot
// extraction of the winner's payload, no float-reciprocal division, no id + 1
// float tape or VMEM spp batches.
//
// What bounds it on an H100: FP32 work in the sweeps actually run, 16
// operations per sphere slot and 46 per triangle slot tested, plus the box
// tests, all counted per thread; and divergence, since a warp runs the union
// of its threads' gated clusters.  The tables do not fit in shared memory
// (field20000's spheres take about 2 MB): they stay in global memory, read
// through the read-only cache, and L2 (50 MB) holds all of them.  Warp-level
// gating, regrouping rays by direction and shared-memory staging of hot
// clusters are left to later work.
#include "mega_common.cuh"

namespace {

using frt::CameraRow;
using frt::Hit;
using frt::kBig;
using frt::PathParams;
using frt::Surface;

constexpr int kThreads = 128;
constexpr int kSlots = 128;  // columns per cluster
// The widening of the slab interval (the TPU kernel's constants).
constexpr float kNearScale = 1.0f - 4e-6f;
constexpr float kFarScale = 1.0f + 4e-6f;
constexpr float kPad = 1e-6f;

// Minimum and maximum that return NaN when either operand is NaN (fminf and
// fmaxf drop it), so that a NaN slab interval reaches the gate's comparison.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The hit tests of the sweep: the arithmetic of DenseScene::closest's
// loops (mega_common.cuh), as functions.
//
// Sphere `c` = (cx, cy, cz, c0) against the ray with od = o.d, oo = o.o by
// the expanded quadratic b = o.d - d.C, c = |o|^2 - 2 o.C + c0.  False
// without a real root; else `t` is the nearest root past t_min, or kBig.
__device__ __forceinline__ bool sphere_t(float4 c, float od, float oo,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float t_min, float& t) {
  const float dc = c.x * dx + c.y * dy + c.z * dz;
  const float oc = c.x * ox + c.y * oy + c.z * oz;
  const float bq = od - dc;
  const float cq = oo - 2.0f * oc + c.w;
  const float disc = bq * bq - cq;
  if (!(disc >= 0.0f)) return false;  // no root (or NaN): a miss
  const float sq = sqrtf(disc);
  const float tn = -bq - sq;
  const float tf = sq - bq;
  t = tn > t_min ? tn : (tf > t_min ? tf : kBig);
  return true;
}

// Moller-Trumbore on the prepacked edges of column `i` of a plane-major
// (24, tp) triangle table: true with the hit's `t` on a hit, false on a
// miss.
__device__ __forceinline__ bool triangle_t(const float* __restrict__ tri,
                                           int tp, int i, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float t_min, float& t) {
  const float e2x = __ldg(&tri[6 * tp + i]);
  const float e2y = __ldg(&tri[7 * tp + i]);
  const float e2z = __ldg(&tri[8 * tp + i]);
  const float e1x = __ldg(&tri[3 * tp + i]);
  const float e1y = __ldg(&tri[4 * tp + i]);
  const float e1z = __ldg(&tri[5 * tp + i]);
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-9f)) return false;
  const float inv = 1.0f / det;
  const float tvx = ox - __ldg(&tri[0 * tp + i]);
  const float tvy = oy - __ldg(&tri[1 * tp + i]);
  const float tvz = oz - __ldg(&tri[2 * tp + i]);
  const float uu = (tvx * px + tvy * py + tvz * pz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float vv = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && t > t_min &&
         t < kBig;
}

// What a segment's sweep did, summed over a thread's paths.
struct ClusterCounters {
  int clusters = 0;   // clusters swept (spheres and triangles)
  int sph_slots = 0;  // sphere slots tested
  int tri_slots = 0;  // triangle slots tested
  int boxes = 0;      // supergroup and cluster boxes slab-tested
};

// The clustered scene (kernels/megakernel_clustered.py::MegaClusteredPack).
//   sph (16, sp): 0-2 center, 3 radius, 4 param, 5-7 albedo, 8-10 albedo2,
//       11 tex_scale, 12 original id, 13 material type, 14 texture type,
//       15 1/radius;
//   mx (sp, 8): cx cy cz c0 pad;
//   tri (24, tp): the dense rows 0-20, 21 material type, 22 texture type;
//   boxes (K, 8) and super boxes (KS, 8): mnx mny mnz mxx mxy mxz pad pad;
//   starts (KS + 1,): first cluster of each supergroup, then K;
//   counts (K,): members of each cluster.
struct ClusterScene {
  const float* sph;
  const float4* mx;
  const float* sph_boxes;
  const float* sph_super;
  const int* sph_starts;
  const int* sph_counts;
  const float* tri;
  const float* tri_boxes;
  const float* tri_super;
  const int* tri_starts;
  const int* tri_counts;
  int ns, nt, ks, kts, sp, tp;
  using Counters = ClusterCounters;

  // Slab test of box `b` against [t_min, bound] with the widened interval;
  // true unless the ray surely misses the box there.
  __device__ __forceinline__ static bool gate(const float* __restrict__ b,
                                              float ox, float oy, float oz,
                                              float ivx, float ivy,
                                              float ivz, float t_min,
                                              float bound) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(b) + 1);
    const float t0x = (lo.x - ox) * ivx, t1x = (lo.w - ox) * ivx;
    const float t0y = (lo.y - oy) * ivy, t1y = (hi.x - oy) * ivy;
    const float t0z = (lo.z - oz) * ivz, t1z = (hi.y - oz) * ivz;
    float near = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                         nan_min(t0z, t1z));
    float far = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                        nan_max(t0z, t1z));
    near = near * kNearScale - kPad;
    far = far * kFarScale + kPad;
    return !(nan_max(near, t_min) > nan_min(far, bound));
  }

  __device__ __forceinline__ void closest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, Hit& h,
                                          Counters& cnt) const {
    const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
    float t_s = kBig;
    int w_s = 0;
    if (ns > 0) {
      const float od = ox * dx + oy * dy + oz * dz;
      const float oo = ox * ox + oy * oy + oz * oz;
      for (int s = 0; s < ks; ++s) {
        ++cnt.boxes;
        if (!gate(sph_super + 8 * s, ox, oy, oz, ivx, ivy, ivz, t_min, t_s))
          continue;
        const int c0 = __ldg(&sph_starts[s]), c1 = __ldg(&sph_starts[s + 1]);
        for (int c = c0; c < c1; ++c) {
          if (c1 - c0 > 1) {
            ++cnt.boxes;
            if (!gate(sph_boxes + 8 * c, ox, oy, oz, ivx, ivy, ivz, t_min,
                      t_s))
              continue;
          }
          const int m = __ldg(&sph_counts[c]);
          ++cnt.clusters;
          cnt.sph_slots += m;
          for (int col = c * kSlots; col < c * kSlots + m; ++col) {
            float t;
            if (!sphere_t(__ldg(&mx[2 * col]), od, oo, ox, oy, oz, dx,
                               dy, dz, t_min, t))
              continue;
            if (t < t_s || (t == t_s && col < w_s)) {
              t_s = t;
              w_s = col;
            }
          }
        }
      }
    }
    float t_t = kBig;
    int w_t = 0;
    if (nt > 0) {
      for (int s = 0; s < kts; ++s) {
        ++cnt.boxes;
        if (!gate(tri_super + 8 * s, ox, oy, oz, ivx, ivy, ivz, t_min,
                  fminf(t_s, t_t)))
          continue;
        const int c0 = __ldg(&tri_starts[s]), c1 = __ldg(&tri_starts[s + 1]);
        for (int c = c0; c < c1; ++c) {
          if (c1 - c0 > 1) {
            ++cnt.boxes;
            if (!gate(tri_boxes + 8 * c, ox, oy, oz, ivx, ivy, ivz, t_min,
                      fminf(t_s, t_t)))
              continue;
          }
          const int m = __ldg(&tri_counts[c]);
          ++cnt.clusters;
          cnt.tri_slots += m;
          for (int col = c * kSlots; col < c * kSlots + m; ++col) {
            float t;
            if (!triangle_t(tri, tp, col, ox, oy, oz, dx, dy, dz, t_min,
                                 t))
              continue;
            if (t < t_t || (t == t_t && col < w_t)) {
              t_t = t;
              w_t = col;
            }
          }
        }
      }
    }
    h.w_s = w_s;
    h.w_t = w_t;
    h.is_tri = t_t < t_s;
    h.t = h.is_tri ? t_t : t_s;
  }

  // The winner's original scene id (payload row 12 / 20).
  __device__ __forceinline__ int original_id(const Hit& h) const {
    return static_cast<int>(h.is_tri ? tri[20 * tp + h.w_t]
                                     : sph[12 * sp + h.w_s]);
  }

  // Material and texture types ride in payload rows (13, 14) / (21, 22).
  __device__ __forceinline__ void surface(const Hit& h, float hx, float hy,
                                          float hz, Surface& f) const {
    if (h.is_tri) {
      const int w = h.w_t;
      f.nx = tri[9 * tp + w];
      f.ny = tri[10 * tp + w];
      f.nz = tri[11 * tp + w];
      f.param = tri[12 * tp + w];
      f.a0r = tri[13 * tp + w];
      f.a0g = tri[14 * tp + w];
      f.a0b = tri[15 * tp + w];
      f.a1r = tri[16 * tp + w];
      f.a1g = tri[17 * tp + w];
      f.a1b = tri[18 * tp + w];
      f.tsc = tri[19 * tp + w];
      f.metal = tri[21 * tp + w] == 1.0f;
      f.diel = tri[21 * tp + w] == 2.0f;
      f.check = tri[22 * tp + w] == 1.0f;
    } else {
      const int w = h.w_s;
      const float inv_r = sph[15 * sp + w];
      f.nx = (hx - sph[0 * sp + w]) * inv_r;
      f.ny = (hy - sph[1 * sp + w]) * inv_r;
      f.nz = (hz - sph[2 * sp + w]) * inv_r;
      f.param = sph[4 * sp + w];
      f.a0r = sph[5 * sp + w];
      f.a0g = sph[6 * sp + w];
      f.a0b = sph[7 * sp + w];
      f.a1r = sph[8 * sp + w];
      f.a1g = sph[9 * sp + w];
      f.a1b = sph[10 * sp + w];
      f.tsc = sph[11 * sp + w];
      f.metal = sph[13 * sp + w] == 1.0f;
      f.diel = sph[13 * sp + w] == 2.0f;
      f.check = sph[14 * sp + w] == 1.0f;
    }
  }
};

__device__ __forceinline__ void write_counters(const ClusterCounters& cnt,
                                               int* __restrict__ out) {
  out[0] = cnt.clusters;
  out[1] = cnt.sph_slots;
  out[2] = cnt.tri_slots;
  out[3] = cnt.boxes;
}

// K3.  At most 128 registers (four blocks an SM): the clustered sweep keeps
// more state than K1's, and spilling it costs more than occupancy.
__global__ void __launch_bounds__(kThreads, 4)
    mega_clustered_kernel(const ClusterScene scene,
                          const float* __restrict__ camp,
                          const PathParams pp, int spp, int num_pixels,
                          float* __restrict__ rad, int* __restrict__ segs,
                          int* __restrict__ sweeps) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= num_pixels) return;
  const CameraRow cam = frt::load_camera(camp);
  const float fi = static_cast<float>(pix % pp.nx);
  const float fj = static_cast<float>(pix / pp.nx);  // bottom-up row
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  int nseg = 0;
  ClusterCounters cnt;
  for (int s = 0; s < spp; ++s) {
    const uint32_t rid = static_cast<uint32_t>(pix) *
                             static_cast<uint32_t>(spp) +
                         static_cast<uint32_t>(s);
    nseg += frt::trace_path<true, false>(scene, cnt, cam, pp, rid, fi, fj,
                                         sum_r, sum_g, sum_b, nullptr, 0);
  }
  rad[3 * pix + 0] = sum_r;
  rad[3 * pix + 1] = sum_g;
  rad[3 * pix + 2] = sum_b;
  segs[pix] = nseg;
  write_counters(cnt, sweeps + 4 * pix);
}

// K3t: K2b's shape on the clustered scene.
__global__ void __launch_bounds__(kThreads, 4)
    record_clustered_kernel(const ClusterScene scene,
                            const float* __restrict__ camp,
                            const PathParams pp, int ray0, int num_rays,
                            int spp_total, int* __restrict__ tape,
                            int* __restrict__ its,
                            int* __restrict__ sweeps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const int rid = ray0 + i;
  const int pix = rid / spp_total;
  const CameraRow cam = frt::load_camera(camp);
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;  // unused: no radiance
  ClusterCounters cnt;
  its[i] = frt::trace_path<false, true>(
      scene, cnt, cam, pp, static_cast<uint32_t>(rid),
      static_cast<float>(pix % pp.nx), static_cast<float>(pix / pp.nx),
      sum_r, sum_g, sum_b, tape + i, static_cast<size_t>(num_rays));
  write_counters(cnt, sweeps + 4 * i);
}

ClusterScene make_scene(const float* sph, const float* mx,
                        const float* sph_boxes, const float* sph_super,
                        const int* sph_starts, const int* sph_counts,
                        const float* tri, const float* tri_boxes,
                        const float* tri_super, const int* tri_starts,
                        const int* tri_counts, int ns, int nt, int ks,
                        int kts, int sp, int tp) {
  return ClusterScene{sph,        reinterpret_cast<const float4*>(mx),
                      sph_boxes,  sph_super,
                      sph_starts, sph_counts,
                      tri,        tri_boxes,
                      tri_super,  tri_starts,
                      tri_counts, ns,
                      nt,         ks,
                      kts,        sp,
                      tp};
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over the whole nx x ny image; writes rad (P, 3)
// f32, segs (P,) i32 and sweeps (P, 4) i32.  The tables are those of
// MegaClusteredPack; `sp` and `tp` are the sphere and triangle column
// counts.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_mega_clustered_render(
    const float* cam, const float* sph, const float* mx,
    const float* sph_boxes, const float* sph_super, const int* sph_starts,
    const int* sph_counts, const float* tri, const float* tri_boxes,
    const float* tri_super, const int* tri_starts, const int* tri_counts,
    int ns, int nt, int ks, int kts, int sp, int tp, unsigned int k0,
    unsigned int k1, int nx, int ny, int spp, int max_depth, float t_min,
    float* rad, int* segs, int* sweeps, void* stream) {
  const ClusterScene scene =
      make_scene(sph, mx, sph_boxes, sph_super, sph_starts, sph_counts, tri,
                 tri_boxes, tri_super, tri_starts, tri_counts, ns, nt, ks,
                 kts, sp, tp);
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const int num_pixels = nx * ny;
  if (num_pixels > 0) {
    const int blocks = (num_pixels + kThreads - 1) / kThreads;
    mega_clustered_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        scene, cam, pp, spp, num_pixels, rad, segs, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K3t on `stream` over ray ids [ray0, ray0 + num_rays); writes tape
// (max_depth + 1, num_rays) i32, its (num_rays,) i32 and sweeps (num_rays, 4)
// i32.  Tables as for frt_mega_clustered_render.  Returns cudaGetLastError()
// after the launch.
int frt_record_clustered(
    const float* cam, const float* sph, const float* mx,
    const float* sph_boxes, const float* sph_super, const int* sph_starts,
    const int* sph_counts, const float* tri, const float* tri_boxes,
    const float* tri_super, const int* tri_starts, const int* tri_counts,
    int ns, int nt, int ks, int kts, int sp, int tp, unsigned int k0,
    unsigned int k1, int nx, int ny, int spp_total, int ray0, int num_rays,
    int max_depth, float t_min, int* tape, int* its, int* sweeps,
    void* stream) {
  const ClusterScene scene =
      make_scene(sph, mx, sph_boxes, sph_super, sph_starts, sph_counts, tri,
                 tri_boxes, tri_super, tri_starts, tri_counts, ns, nt, ks,
                 kts, sp, tp);
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    record_clustered_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        scene, cam, pp, ray0, num_rays, spp_total, tape, its, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
