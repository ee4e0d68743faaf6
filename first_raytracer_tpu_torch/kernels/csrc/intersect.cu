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
// t.  That is the lexicographic minimum of (t, prim) over every hit, the
// argmin convention of the TPU kernel.
//
// K5 (`intersect_clustered_kernel`) replaces
// first_raytracer_tpu/kernels/intersect_clustered.py:272 _sphere_pass_kernel
// and :313 _tri_pass_kernel, the two passes of the two-level clustered
// closest hit.  The host (kernels/intersect_clustered.py::
// pack_scene_clustered) cuts each primitive type into SAH clusters of at
// most 128 slots, each with a box, and bounds every run of 8 consecutive
// clusters by a supergroup box.  One thread per ray runs the sphere pass,
// then the triangle pass seeded with the sphere pass's (t, gid): each
// supergroup box is slab-tested against the ray's current best t
// (slab.cuh::slab_gate, conservative), then the boxes of the clusters of
// every supergroup that passes, and the members of every cluster that passes
// are swept.  Each hit folds into the running winner as the lexicographic
// minimum of (t, global id) (the TPU kernels' `_fold`), so the result does
// not depend on the order of the sweep or on which gates fire, and a sphere
// (ids below Ns) wins a sphere/triangle tie.  With the conservative gate, K5
// picks K4's winner on every ray.
//
// Both kernels compute each (ray, primitive) pair with the operation order
// of the TPU kernels and of the plain versions (kernels/intersect_pallas.py
// and intersect_clustered.py), built with --fmad=false, so the three agree
// bit for bit on t.  A sphere is read as (cx, cy, cz, r*r) and a triangle as
// (v0, e1 = v1 - v0, e2 = v2 - v0): each rounded once in f32, the numbers
// the loop would compute, so the pair costs 16 and 46 FP32 operations.
//
// The TPU layout is not carried over: no ray tiles of 512 padded with dummy
// rays, no transposed (3, R) ray planes, no sentinel columns (1e30 centres,
// zero triangles) that miss through inf and NaN arithmetic, no C_BLK blocks
// of statically unrolled clusters, no ray-tile gates opened by any ray of
// the tile, and no global ids carried as f32 rows: the kernels loop over
// the true counts and read int32 ids.
//
// What bounds them on an H100, and what the design does about it:
//  - K4 is bound by instruction issue: every (ray, primitive) pair is
//    tested, and without FMA each FP32 operation is one instruction.  The
//    rays, 24 bytes in and 8 out each, are far below that.  So every
//    instruction around the 16 operations of a sphere goes where it can:
//    the block stages the primitives through shared memory in tiles (512
//    spheres or 256 triangles; cp.async copies the next tile's planes while
//    the warps sweep the current one) rewritten in the forms above, so a
//    pair reads one 16-byte shared-memory broadcast (three for a triangle)
//    and not four (nine) global loads; each thread tests kDenseRays rays
//    against every staged primitive, so one read feeds that many chains;
//    and a group of kGroup spheres shares one branch to the rare root, so
//    a miss costs its 16 operations and a compare.  kDenseSplit lanes may
//    share a ray's primitive loop and meet in a (t, prim) warp-shuffle
//    minimum.
//  - K5 is bound by its gates and by the union of the clusters its warp's
//    rays sweep.  The supergroup level cuts the box tests from one per
//    cluster to one per supergroup plus the clusters of those that pass.
//    The gate tables (supergroup boxes, cluster boxes, member counts) go
//    through shared memory in tiles of kSuperTile supergroups, copied with
//    cp.async one tile ahead; the members of the swept clusters stay in
//    device memory, read as 16-byte (cx, cy, cz, r*r) and (v0, e1, e2) rows,
//    the spheres in groups as in K4.
#include "cp_async.cuh"
#include "mega_common.cuh"
#include "slab.cuh"

#include <climits>
#include <cmath>

namespace {

using frt::commit_copies;
using frt::copy16_async;
using frt::kBig;
using frt::kGroup;  // spheres whose discriminants share a branch
using frt::round4;
using frt::slab_gate;
using frt::wait_copies;

constexpr int kThreads = 128;
constexpr int kSlots = 128;  // slots per cluster

// K4's work per thread: rays tested against each staged primitive, and
// lanes that share one ray's primitive loop.  Measured on the card over
// {1, 2, 4}^2 (probes/k4_grid.py; the grid is in PERF.md): two rays a
// thread, one lane a ray, was the fastest on every shape tried (4 rays
// spill).
constexpr int kDenseRays = 2;
constexpr int kDenseSplit = 1;
static_assert(kDenseSplit == 1 || kDenseSplit == 2 || kDenseSplit == 4,
              "the split lanes of a ray must sit in one warp");

constexpr int kSphereTile = 512;    // spheres per K4 tile (8 KB)
constexpr int kTriangleTile = 256;  // triangles per K4 tile (12 KB)
constexpr int kFanout = 8;          // clusters per supergroup
constexpr int kSuperTile = 32;      // supergroups per K5 tile (10 KB)

// Copies `n` floats (n a multiple of 4, both ends 16-byte aligned) with the
// block's threads.
__device__ __forceinline__ void copy_floats_async(float* dst,
                                                  const float* src, int n) {
  for (int q = threadIdx.x; q < n / 4; q += kThreads)
    copy16_async(dst + 4 * q, src + 4 * q);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// ---------------------------------------------------------------------------
// The pair tests.
// ---------------------------------------------------------------------------

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The oc-form sphere test of geometry/sphere.py on s = (cx, cy, cz, r*r),
// in two steps.  sphere_disc: b and the discriminant, 16 operations; a
// sphere (0, 0, 0, -inf) never has disc > 0 (c is +inf, or NaN).
__device__ __forceinline__ void sphere_disc(float4 s, const Ray& r, float& b,
                                            float& disc) {
  const float ocx = r.ox - s.x;
  const float ocy = r.oy - s.y;
  const float ocz = r.oz - s.z;
  b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
  disc = b * b - c;
}

// sphere_root, for disc > 0: true with the nearest root in (t_min, kBig)
// in t.
__device__ __forceinline__ bool sphere_root(float b, float disc, float t_min,
                                            float& t) {
  const float sq = sqrtf(disc);
  const float tn = -b - sq;
  if (tn > t_min && tn < kBig) {
    t = tn;
    return true;
  }
  const float tf = -b + sq;
  t = tf;
  return tf > t_min && tf < kBig;
}

// Moller-Trumbore on v0, e1 = v1 - v0, e2 = v2 - v0 (the .w lanes unused):
// true with t in (t_min, kBig).
__device__ __forceinline__ bool triangle_mt(float4 v0, float4 e1, float4 e2,
                                            const Ray& r, float t_min,
                                            float& t) {
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  if (!(fabsf(det) > 1e-9f)) return false;
  const float inv = 1.0f / det;
  const float tx = r.ox - v0.x;
  const float ty = r.oy - v0.y;
  const float tz = r.oz - v0.z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv;
  return u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > t_min && t < kBig;
}

// ---------------------------------------------------------------------------
// K4: the dense closest hit.
// ---------------------------------------------------------------------------

// kGroup spheres s[g] against one ray: their discriminants first, then,
// only if one is positive, the roots in g order, each hit passed to
// fold(t, g).  The root is rare, so the miss path of a sphere is its 16
// operations and a compare, with one branch per group.
template <class Fold>
__device__ __forceinline__ void sphere_group(const float4 (&s)[kGroup],
                                             const Ray& r, float t_min,
                                             Fold fold) {
  float b[kGroup], disc[kGroup];
  bool any = false;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    sphere_disc(s[g], r, b[g], disc[g]);
    any |= disc[g] > 0.0f;
  }
  if (!any) return;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    float t;
    if (disc[g] > 0.0f && sphere_root(b[g], disc[g], t_min, t)) fold(t, g);
  }
}

// The two primitive types of a K4 tile: the planes a tile is copied from,
// its rows in shared memory, the rewrite of one into the other, and the
// sweep of a tile's m primitives (numbered from `base`) by this lane.
struct SphereTile {
  static constexpr int kPlanes = 4;  // cx cy cz r
  static constexpr int kVecs = 1;    // float4 rows per sphere
  static constexpr int kTile = kSphereTile;

  // raw: kPlanes planes of `pitch` floats; n spheres, padded to round16(n)
  // with never-hit spheres, so that the sweep takes whole groups.
  __device__ static void rewrite(const float* raw, int pitch, int n,
                                 float4* tile) {
    for (int k = threadIdx.x; k < round16(n); k += kThreads) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
      if (k < n) {
        const float r = raw[3 * pitch + k];
        s = make_float4(raw[k], raw[pitch + k], raw[2 * pitch + k], r * r);
      }
      tile[k] = s;
    }
  }

  template <int R, int S>
  __device__ static void sweep(const float4* tile, int m, int base,
                               const Ray (&ray)[R], float t_min,
                               float (&t_best)[R], int (&p_best)[R],
                               int sub) {
    for (int k = sub; k < m; k += kGroup * S) {
      float4 s[kGroup];  // one shared read each, for every ray
#pragma unroll
      for (int g = 0; g < kGroup; ++g) s[g] = tile[k + g * S];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sphere_group(s, ray[r], t_min, [&](float t, int g) {
          if (t < t_best[r]) {  // the first strict minimum of this lane
            t_best[r] = t;
            p_best[r] = base + k + g * S;
          }
        });
    }
  }
};

struct TriangleTile {
  static constexpr int kPlanes = 9;  // v0 v1 v2
  static constexpr int kVecs = 3;
  static constexpr int kTile = kTriangleTile;

  __device__ static void rewrite(const float* raw, int pitch, int n,
                                 float4* tile) {
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float v0x = raw[k], v0y = raw[pitch + k], v0z = raw[2 * pitch + k];
      tile[3 * k] = make_float4(v0x, v0y, v0z, 0.0f);
      tile[3 * k + 1] = make_float4(raw[3 * pitch + k] - v0x,
                                    raw[4 * pitch + k] - v0y,
                                    raw[5 * pitch + k] - v0z, 0.0f);
      tile[3 * k + 2] = make_float4(raw[6 * pitch + k] - v0x,
                                    raw[7 * pitch + k] - v0y,
                                    raw[8 * pitch + k] - v0z, 0.0f);
    }
  }

  template <int R, int S>
  __device__ static void sweep(const float4* tile, int m, int base,
                               const Ray (&ray)[R], float t_min,
                               float (&t_best)[R], int (&p_best)[R],
                               int sub) {
#pragma unroll 2
    for (int k = sub; k < m; k += S) {
      const float4 v0 = tile[3 * k], e1 = tile[3 * k + 1],
                   e2 = tile[3 * k + 2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float t;
        if (triangle_mt(v0, e1, e2, ray[r], t_min, t) && t < t_best[r]) {
          t_best[r] = t;
          p_best[r] = base + k;
        }
      }
    }
  }
};

// Floats of one raw buffer of a type's tile: its planes at a pitch of
// round4(min(n, kTile)) floats; the rewritten tile's rows, round16 of it.
template <class P>
__host__ __device__ constexpr int raw_pitch(int n) {
  return round4(n < P::kTile ? n : P::kTile);
}
template <class P>
__host__ __device__ constexpr int tile_rows(int n) {
  return round16(n < P::kTile ? n : P::kTile);
}

// The number of raw buffers a pass over n primitives cycles through.
template <class P>
__host__ __device__ constexpr int raw_buffers(int n) {
  return n > P::kTile ? 2 : 1;
}

// K4's shared memory for ns spheres and nt triangles: the raw buffers
// (floats, a multiple of 4), then the rewritten tile, each sized for the
// larger pass.
template <class P>
__host__ __device__ constexpr int raw_floats(int n) {
  return raw_buffers<P>(n) * P::kPlanes * raw_pitch<P>(n);
}
__host__ __device__ constexpr int dense_raw_floats(int ns, int nt) {
  return raw_floats<SphereTile>(ns) > raw_floats<TriangleTile>(nt)
             ? raw_floats<SphereTile>(ns)
             : raw_floats<TriangleTile>(nt);
}

int dense_smem_bytes(int ns, int nt) {
  const int tile_s = SphereTile::kVecs * tile_rows<SphereTile>(ns);
  const int tile_t = TriangleTile::kVecs * tile_rows<TriangleTile>(nt);
  return 4 * dense_raw_floats(ns, nt) +
         16 * (tile_s > tile_t ? tile_s : tile_t);
}

// One pass of K4 over n primitives of type P (plane-major, `pitch` columns;
// primitive k numbered index0 + k): tile j + 1 is in flight while tile j is
// swept; this thread's rays fold their hits into (t_best, p_best), this lane
// taking the primitives k = sub (mod S) of each tile.
template <class P, int R, int S>
__device__ __forceinline__ void dense_pass(const float* __restrict__ planes,
                                           int n, int pitch, int index0,
                                           const Ray (&ray)[R], float t_min,
                                           float (&t_best)[R],
                                           int (&p_best)[R], float* raw,
                                           float4* tile, int sub) {
  const int tiles = (n + P::kTile - 1) / P::kTile;
  if (tiles == 0) return;
  const int rp = raw_pitch<P>(n);
  auto stage = [&](int j) {  // tile j's planes into raw buffer j % 2
    const int k0 = j * P::kTile;
    const int w = round4(min(P::kTile, n - k0));  // within the padded plane
    for (int p = 0; p < P::kPlanes; ++p)
      copy_floats_async(raw + ((j & 1) * P::kPlanes + p) * rp,
                        planes + static_cast<size_t>(p) * pitch + k0, w);
  };
  stage(0);
  commit_copies();
  if (tiles > 1) stage(1);
  commit_copies();
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * P::kTile;
    const int m = min(P::kTile, n - k0);
    wait_copies<1>();  // tile j has landed; tile j + 1 may be in flight
    __syncthreads();   // ... for every thread; the last tile is swept
    P::rewrite(raw + (j & 1) * P::kPlanes * rp, rp, m, tile);
    __syncthreads();   // the tile is written; raw buffer j % 2 is free
    if (j + 2 < tiles) stage(j + 2);
    commit_copies();
    P::template sweep<R, S>(tile, m, index0 + k0, ray, t_min, t_best, p_best,
                            sub);
  }
}

// K4.  sph (8, sp) planes: cx cy cz r; tri (16, tp) planes: v0 v1 v2.  Ray
// r of the thread in lane group g = threadIdx.x / S of block b is ray
// b * (kThreads / S) * R + r * (kThreads / S) + g.
template <int R, int S>
__global__ void __launch_bounds__(kThreads)
    intersect_dense_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ sph, int ns, int sp,
                           const float* __restrict__ tri, int nt, int tp,
                           int num_rays, float t_min, float* __restrict__ t_out,
                           int* __restrict__ prim_out) {
  extern __shared__ float4 smem[];
  constexpr int kGroups = kThreads / S;
  const int g = threadIdx.x / S;
  const int sub = threadIdx.x % S;
  const int first = blockIdx.x * kGroups * R + g;
  Ray ray[R];
  float t_best[R];
  int p_best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(first + r * kGroups, num_rays - 1);  // tail: repeat
    ray[r] = Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                 d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    t_best[r] = kBig;
    p_best[r] = 0;
  }
  float* raw = reinterpret_cast<float*>(smem);
  float4* tile = smem + dense_raw_floats(ns, nt) / 4;
  dense_pass<SphereTile, R, S>(sph, ns, sp, 0, ray, t_min, t_best, p_best,
                               raw, tile, sub);
  dense_pass<TriangleTile, R, S>(tri, nt, tp, ns, ray, t_min, t_best, p_best,
                                 raw, tile, sub);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int lane = 1; lane < S; lane <<= 1) {  // the (t, prim) minimum
      const float t = __shfl_xor_sync(0xffffffffu, t_best[r], lane);
      const int p = __shfl_xor_sync(0xffffffffu, p_best[r], lane);
      if (t < t_best[r] || (t == t_best[r] && p < p_best[r])) {
        t_best[r] = t;
        p_best[r] = p;
      }
    }
    const int i = first + r * kGroups;
    if (sub == 0 && i < num_rays) {
      t_out[i] = t_best[r];
      prim_out[i] = p_best[r];
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the clustered closest hit.
// ---------------------------------------------------------------------------

// What a ray's clustered sweep did.
struct Counters {
  int clusters = 0;   // clusters swept (spheres and triangles)
  int sph_slots = 0;  // sphere slots tested
  int tri_slots = 0;  // triangle slots tested
  int boxes = 0;      // supergroup and cluster boxes slab-tested
};

// The lexicographic (t, gid) fold of one hit into the running winner.
__device__ __forceinline__ void fold(float t, int g, float& t_best,
                                     int& g_best) {
  if (t < t_best || (t == t_best && t < kBig && g < g_best)) {
    t_best = t;
    g_best = g;
  }
}

// One primitive type of the clustered pack: rows (K_pad * 128 * kVecs)
// float4, cluster k's slot j in rows (128 k + j) * kVecs; boxes (K_pad, 8)
// and supers (K_pad / 8, 8): mnx mny mnz mxx mxy mxz pad pad; gids
// (K_pad, 128) i32; counts (K_pad,) i32, the members filling each cluster's
// first slots; k the true cluster count.
struct ClusterTables {
  const float4* rows;
  const float* boxes;
  const float* supers;
  const int* gids;
  const int* counts;
  int k;
};

// A K5 tile of `ts` supergroups in shared memory, in float4 units: their
// boxes [0, 2 ts), their clusters' boxes [2 ts, 18 ts), the clusters'
// member counts (int) [18 ts, 20 ts).
__host__ __device__ constexpr int gate_tile_vecs(int ts) { return 20 * ts; }

// Supergroups per K5 tile for kss_s and kss_t supergroups.
__host__ __device__ constexpr int gate_tile_supers(int kss_s, int kss_t) {
  return (kss_s > kss_t ? kss_s : kss_t) < kSuperTile
             ? (kss_s > kss_t ? kss_s : kss_t)
             : kSuperTile;
}

__host__ __device__ constexpr int supers_of(int k) {
  return (k + kFanout - 1) / kFanout;
}

int clustered_smem_bytes(int ks, int kt) {
  const int kss_s = supers_of(ks), kss_t = supers_of(kt);
  const int ts = gate_tile_supers(kss_s, kss_t);
  if (ts == 0) return 0;
  const int most = kss_s > kss_t ? kss_s : kss_t;
  return 16 * gate_tile_vecs(ts) * (most > ts ? 2 : 1);
}

// One pass of K5 over the clusters of one type: tile j + 1 of the gate
// tables is in flight while the block's rays sweep tile j.  `TRI` picks the
// triangle test and counter.
template <bool TRI>
__device__ __forceinline__ void clustered_pass(
    const ClusterTables& c, int ts, float4* smem, bool live, const Ray& ray,
    float ivx, float ivy, float ivz, float t_min, float& t_best, int& g_best,
    Counters& cnt) {
  const int kss = supers_of(c.k);
  if (kss == 0) return;
  const int tiles = (kss + ts - 1) / ts;
  auto stage = [&](int j) {  // tile j into buffer j % 2
    float4* buf = smem + (j & 1) * gate_tile_vecs(ts);
    const int s0 = j * ts;
    const int ns = min(ts, kss - s0);
    const int c0 = s0 * kFanout;
    const int nc = min(ts * kFanout, c.k - c0);
    copy_floats_async(reinterpret_cast<float*>(buf), c.supers + 8 * s0,
                      8 * ns);
    copy_floats_async(reinterpret_cast<float*>(buf + 2 * ts),
                      c.boxes + 8 * c0, 8 * nc);
    // Counts up to a multiple of 4: within the K_pad (a multiple of 16).
    copy_floats_async(reinterpret_cast<float*>(buf + 18 * ts),
                      reinterpret_cast<const float*>(c.counts + c0),
                      round4(nc));
  };
  stage(0);
  commit_copies();
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage(j + 1);  // its buffer was freed by the sync
    commit_copies();                  // below the sweep of tile j - 1
    wait_copies<1>();
    __syncthreads();  // tile j has landed for every thread
    const float4* buf = smem + (j & 1) * gate_tile_vecs(ts);
    const int* counts = reinterpret_cast<const int*>(buf + 18 * ts);
    const int s0 = j * ts;
    const int ns = min(ts, kss - s0);
    const int c0 = s0 * kFanout;
    const int nc = min(ts * kFanout, c.k - c0);
    for (int s = 0; live && s < ns; ++s) {
      ++cnt.boxes;
      if (!slab_gate(buf[2 * s], buf[2 * s + 1], ray.ox, ray.oy, ray.oz, ivx,
                     ivy, ivz, t_min, t_best))
        continue;
      const int end = min(kFanout * (s + 1), nc);
      for (int q = kFanout * s; q < end; ++q) {
        ++cnt.boxes;
        if (!slab_gate(buf[2 * ts + 2 * q], buf[2 * ts + 2 * q + 1], ray.ox,
                       ray.oy, ray.oz, ivx, ivy, ivz, t_min, t_best))
          continue;
        const int m = counts[q];
        const size_t slot0 = static_cast<size_t>(c0 + q) * kSlots;
        ++cnt.clusters;
        if (TRI) {
          cnt.tri_slots += m;
          const float4* p = c.rows + 3 * slot0;
          for (int jj = 0; jj < m; ++jj) {
            float t;
            if (triangle_mt(__ldg(p + 3 * jj), __ldg(p + 3 * jj + 1),
                            __ldg(p + 3 * jj + 2), ray, t_min, t))
              fold(t, __ldg(&c.gids[slot0 + jj]), t_best, g_best);
          }
        } else {
          // Whole groups: the empty slots past m hold never-hit spheres.
          cnt.sph_slots += m;
          const float4* p = c.rows + slot0;
          for (int jj = 0; jj < m; jj += kGroup) {
            float4 s[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) s[g] = __ldg(p + jj + g);
            sphere_group(s, ray, t_min, [&](float t, int g) {
              fold(t, __ldg(&c.gids[slot0 + jj + g]), t_best, g_best);
            });
          }
        }
      }
    }
    __syncthreads();  // every thread is done with buffer j % 2
  }
}

// K5: the sphere pass, then the triangle pass seeded by its winner.
__global__ void __launch_bounds__(kThreads)
    intersect_clustered_kernel(const float* __restrict__ o,
                               const float* __restrict__ d, ClusterTables sph,
                               ClusterTables tri, int num_rays, float t_min,
                               float* __restrict__ t_out,
                               int* __restrict__ prim_out,
                               int* __restrict__ counters) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < num_rays;
  const int ii = live ? i : num_rays - 1;
  const Ray ray{o[3 * ii], o[3 * ii + 1], o[3 * ii + 2],
                d[3 * ii], d[3 * ii + 1], d[3 * ii + 2]};
  const float ivx = 1.0f / ray.dx, ivy = 1.0f / ray.dy, ivz = 1.0f / ray.dz;
  const int ts = gate_tile_supers(supers_of(sph.k), supers_of(tri.k));
  float t_best = kBig;
  int g_best = INT_MAX;
  Counters cnt;
  clustered_pass<false>(sph, ts, smem, live, ray, ivx, ivy, ivz, t_min,
                        t_best, g_best, cnt);
  clustered_pass<true>(tri, ts, smem, live, ray, ivx, ivy, ivz, t_min,
                       t_best, g_best, cnt);
  if (!live) return;
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
// kernels/intersect_pallas.py::PallasScenePack (16-byte aligned); `sp`, `tp`
// their column counts.  Returns cudaGetLastError() after the launch (0 =
// launched).
int frt_intersect_dense(const float* o, const float* d, const float* sph,
                        int ns, int sp, const float* tri, int nt, int tp,
                        int num_rays, float t_min, float* t, int* prim,
                        void* stream) {
  if (num_rays > 0) {
    constexpr int kRaysPerBlock = kThreads / kDenseSplit * kDenseRays;
    const int blocks = (num_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    intersect_dense_kernel<kDenseRays, kDenseSplit>
        <<<blocks, kThreads, dense_smem_bytes(ns, nt),
           static_cast<cudaStream_t>(stream)>>>(o, d, sph, ns, sp, tri, nt,
                                                tp, num_rays, t_min, t, prim);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K5 (both passes) on `stream`; writes t, prim and, unless
// `counters` is null, counters (num_rays, 4) i32.  The tables are those of
// kernels/intersect_clustered.py::ClusteredScenePack (16-byte aligned): per
// type the (cx, cy, cz, r*r) or (v0, e1, e2) rows, the cluster and
// supergroup boxes, the int32 gids and counts, and the true cluster count.
// Returns cudaGetLastError() after the launch.
int frt_intersect_clustered(const float* o, const float* d,
                            const float* sph_rows, const float* sph_box,
                            const float* sph_super, const int* sph_gid,
                            const int* sph_count, int ks,
                            const float* tri_rows, const float* tri_box,
                            const float* tri_super, const int* tri_gid,
                            const int* tri_count, int kt, int num_rays,
                            float t_min, float* t, int* prim, int* counters,
                            void* stream) {
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    const ClusterTables sph{reinterpret_cast<const float4*>(sph_rows),
                            sph_box, sph_super, sph_gid, sph_count, ks};
    const ClusterTables tri{reinterpret_cast<const float4*>(tri_rows),
                            tri_box, tri_super, tri_gid, tri_count, kt};
    intersect_clustered_kernel<<<blocks, kThreads,
                                 clustered_smem_bytes(ks, kt),
                                 static_cast<cudaStream_t>(stream)>>>(
        o, d, sph, tri, num_rays, t_min, t, prim, counters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
