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
// ~40 ops on (R, N, 3) temporaries).  For every live ray, the t of every
// sphere (the oc-form quadratic, near root then far root in (t_min, BIG))
// and of every triangle (Moller-Trumbore), then torch.argmin over them: the
// first minimum, so the lowest global id wins a tie and a triangle
// (numbered from Ns) displaces a sphere only at a strictly smaller t; all
// BIG gives prim 0.  No candidate is NaN: each passes ordered comparisons
// or is BIG (torch_hits.cuh), so argmin's NaN rule never applies and the
// first minimum is the lexicographic minimum of (t, global id), whatever
// order the primitives are swept in.  A ray the caller's liveness mask
// marks dead is not swept and gets the miss (prim 0, t = BIG, hit false):
// intersect_brute then torch.where on the mask.  Outputs (prim int32, t
// float32, hit = t < BIG), each (R,).
//
// Bit-equality with intersect_brute as torch runs it on the same device
// (torch_hits.cuh): the sums over rows of three of the broadcast (R, N, 3)
// products in torch's order for the device, r * r and the edges v1 - v0,
// v2 - v0 rounded once (torch computes them per pair, the same numbers),
// the cross products as torch.linalg.cross, IEEE sqrtf and 1 / det, no
// contraction (--fmad=false), and _roots' branch order.
//
// What bounds it on an H100 (utils/roofline.py): instruction issue on the
// live (ray, primitive) pairs.  Without FMA each of a sphere pair's 16 FP32
// operations is an instruction (46 a triangle's), against 24 bytes read and
// 9 written a ray and the mask's R bytes.  The callers' loops hand it every
// ray of a state in which, past the first bounces, most rays are dead.  So:
//  - Live rays only, in full warps.  A block takes a window of kWindow
//    consecutive rays, ballots the mask a warp at a time, packs the live
//    rays' indices in order into shared memory (the warps' counts give
//    each its offset) and writes the miss of the dead ones itself; its
//    warps then sweep the packed list, so a dead ray costs its byte of
//    the mask and its 9 bytes out, and a warp with no live ray in its
//    share of the list issues no pair.  The window is the block's own: no
//    scratch (the launch allocates only its outputs), no grid-wide list
//    (it would need a ticket and epoch-tagged counters, as K9's scan has,
//    and blocks waiting on the blocks before them) and no order between
//    blocks; a window with no live ray skips the scene.  What that costs:
//    the work of a block is its own window's, so a window just over half
//    live still takes two chains a lane (0.040 ms at 50% live against
//    0.044 all live, 0.0124 at 10%, 0.0050 at 1%, 0.0019 with none).
//  - Many live rays (more than a ray a thread): kRays rays a thread, so
//    one shared-memory broadcast of a sphere (cx, cy, cz, r * r) feeds two
//    chains, and kGroup spheres whose discriminants share one branch to
//    the rare root: a miss costs its 16 operations and a compare.  Eight
//    spheres a group, not K4's four: 0.044 ms at 2^17 live rays of the
//    final scene against 0.050 (which spilled at 80 registers; 111
//    without spills with eight; sixteen took 161 and 0.058 ms), and no
//    slower at any live share (probes/k11_grid.py, NVIDIA H100 80GB HBM3,
//    700 W).
//  - Few live rays: with L live rays in the window each ray's primitive
//    loop is split over S lanes, S the largest power of two up to 32 with
//    L * S <= kThreads (each lane takes every S-th sphere and triangle),
//    and the lanes meet in a (t, global id) warp-shuffle minimum, which is
//    argmin's first minimum as said above.  S is chosen on the device from
//    the window's live count: nothing is read on the host.
//  - The scene is read from its tensors at every launch (no pack: a scene
//    moved in place is read anew, also under a CUDA graph), in tiles of
//    kSphereTile spheres and kTriangleTile triangles: cp.async copies a
//    tile's raw rows into shared memory while the warps sweep the tile
//    before it (the first one once the block knows it has a live ray:
//    staged before, the reads of the windows without one cost every
//    launch 0.6 us at 0 live, probes/k11_grid.py), then the block rewrites
//    them as (cx, cy, cz, r * r), padded with never-hit spheres to whole
//    groups of every split, and (v0, e1, e2).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cp_async.cuh"
#include "torch_hits.cuh"

namespace {

using namespace frt::th;
using frt::commit_copies;
using frt::copy4_async;
using frt::kBig;
using frt::wait_copies;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 2;                   // rays a thread, many live rays
constexpr int kWindow = kRays * kThreads;  // rays a block
constexpr int kGroup = 8;     // spheres whose discriminants share a branch
constexpr int kMaxSplit = 32;  // lanes of a ray, few live rays
constexpr int kPad = kGroup * kMaxSplit;  // spheres a tile is padded to
constexpr int kSphereTile = 512;    // spheres a tile (8 KB)
constexpr int kTriangleTile = 256;  // triangles a tile (12 KB)
static_assert(kSphereTile % kPad == 0, "a tile pads within itself");

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The block's shared memory for ns spheres and nt triangles, in float4s:
// the rewritten tile, then the raw rows of the tile in flight (floats,
// rounded to float4s), then the window's list and its warps' counts.
__host__ __device__ constexpr int tile_vecs(int ns, int nt) {
  return imax(round_up(imin(ns, kSphereTile), kPad),
              3 * imin(nt, kTriangleTile));
}
__host__ __device__ constexpr int raw_vecs(int ns, int nt) {
  return round_up(imax(4 * imin(ns, kSphereTile),
                       9 * imin(nt, kTriangleTile)), 4) / 4;
}
constexpr int kListVecs = (kWindow + kRays * kWarps + 3) / 4;

int dense_smem_bytes(int ns, int nt) {
  return 16 * (tile_vecs(ns, nt) + raw_vecs(ns, nt) + kListVecs);
}

struct Scene {
  const float* center;  // (ns, 3)
  const float* radius;  // (ns,)
  const float* v0;      // (nt, 3)
  const float* v1;
  const float* v2;
  int ns, nt;
};

// A launch's rays, their liveness and its outputs, each (n,) or (n, 3).
struct Rays {
  const float* origin;
  const float* direction;
  const uint8_t* alive;  // null: every ray live
  int64_t n;
  float t_min;
  int* prim;
  float* t;
  uint8_t* hit;
};

// Tiles 0 .. sphere_tiles - 1 are spheres, the rest triangles.
__device__ __forceinline__ int sphere_tiles(const Scene& sc) {
  return (sc.ns + kSphereTile - 1) / kSphereTile;
}

// Tile j's raw rows into `raw`, asynchronously: a sphere tile's m centres
// (3 m floats) then radii; a triangle tile's v0, v1, v2 (3 m floats each).
__device__ __forceinline__ void stage(const Scene& sc, int j, float* raw) {
  const int ts = sphere_tiles(sc);
  if (j < ts) {
    const int k0 = j * kSphereTile;
    const int m = imin(kSphereTile, sc.ns - k0);
    for (int q = threadIdx.x; q < 3 * m; q += kThreads)
      copy4_async(raw + q, sc.center + 3 * k0 + q);
    for (int q = threadIdx.x; q < m; q += kThreads)
      copy4_async(raw + 3 * m + q, sc.radius + k0 + q);
  } else {
    const int k0 = (j - ts) * kTriangleTile;
    const int m = imin(kTriangleTile, sc.nt - k0);
    for (int q = threadIdx.x; q < 3 * m; q += kThreads) {
      copy4_async(raw + q, sc.v0 + 3 * k0 + q);
      copy4_async(raw + 3 * m + q, sc.v1 + 3 * k0 + q);
      copy4_async(raw + 6 * m + q, sc.v2 + 3 * k0 + q);
    }
  }
}

// Tile j's raw rows rewritten into `tile`; returns the tile's primitives.
__device__ __forceinline__ int rewrite(const Scene& sc, int j,
                                       const float* raw, float4* tile) {
  const int ts = sphere_tiles(sc);
  if (j < ts) {
    const int m = imin(kSphereTile, sc.ns - j * kSphereTile);
    for (int k = threadIdx.x; k < round_up(m, kPad); k += kThreads) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, -INFINITY);  // never hit
      if (k < m) {
        const float r = raw[3 * m + k];
        s = make_float4(raw[3 * k], raw[3 * k + 1], raw[3 * k + 2], r * r);
      }
      tile[k] = s;
    }
    return m;
  }
  const int m = imin(kTriangleTile, sc.nt - (j - ts) * kTriangleTile);
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const V3 v0{raw[3 * k], raw[3 * k + 1], raw[3 * k + 2]};
    const V3 e1 = sub(V3{raw[3 * m + 3 * k], raw[3 * m + 3 * k + 1],
                         raw[3 * m + 3 * k + 2]}, v0);
    const V3 e2 = sub(V3{raw[6 * m + 3 * k], raw[6 * m + 3 * k + 1],
                         raw[6 * m + 3 * k + 2]}, v0);
    tile[3 * k] = make_float4(v0.x, v0.y, v0.z, 0.0f);
    tile[3 * k + 1] = make_float4(e1.x, e1.y, e1.z, 0.0f);
    tile[3 * k + 2] = make_float4(e2.x, e2.y, e2.z, 0.0f);
  }
  return m;
}

// _roots for disc = b * b - cc > 0: the near root, else the far one, in
// (t_min, BIG), else BIG (torch_hits.cuh::sphere_roots past `has`).
__device__ __forceinline__ float root(float b, float disc, float t_min) {
  const float sq = sqrtf(disc);
  const float tn = -b - sq;
  const float tf = -b + sq;
  const bool near_ok = tn > t_min && tn < kBig;
  const bool far_ok = tf > t_min && tf < kBig;
  return near_ok ? tn : (far_ok ? tf : kBig);
}

// This lane's part of a sphere tile (rows padded to whole groups of every
// split) against its R rays: the groups of kGroup spheres k, k + S, ...,
// k + (kGroup - 1) S for k = part (mod kGroup S), each read once for every
// ray, their discriminants first and one branch to the roots.  A lane
// sweeps its spheres in increasing id, so a strict `<` keeps its first
// minimum.
template <int R, int S>
__device__ __forceinline__ void sweep_spheres(const float4* tile, int m,
                                              int base, const V3 (&o)[R],
                                              const V3 (&d)[R], float t_min,
                                              float (&bt)[R], int (&bp)[R],
                                              int part) {
  for (int k = part; k < m; k += kGroup * S) {
    float4 s[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) s[g] = tile[k + g * S];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float b[kGroup], disc[kGroup];
      bool any = false;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const V3 oc = sub(o[r], V3{s[g].x, s[g].y, s[g].z});
        b[g] = dot(oc, d[r]);
        const float cc = dot(oc, oc) - s[g].w;
        disc[g] = b[g] * b[g] - cc;
        any |= disc[g] > 0.0f;
      }
      if (!any) continue;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (!(disc[g] > 0.0f)) continue;
        const float t = root(b[g], disc[g], t_min);
        if (t < bt[r]) {
          bt[r] = t;
          bp[r] = base + k + g * S;
        }
      }
    }
  }
}

template <int R, int S>
__device__ __forceinline__ void sweep_triangles(const float4* tile, int m,
                                                int base, const V3 (&o)[R],
                                                const V3 (&d)[R],
                                                float t_min, float (&bt)[R],
                                                int (&bp)[R], int part) {
#pragma unroll 2
  for (int k = part; k < m; k += S) {
    const float4 a = tile[3 * k], b = tile[3 * k + 1], c = tile[3 * k + 2];
    const V3 v0{a.x, a.y, a.z}, e1{b.x, b.y, b.z}, e2{c.x, c.y, c.z};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float t = triangle_t(o[r], d[r], v0, e1, e2, t_min);
      if (t < bt[r]) {
        bt[r] = t;
        bp[r] = base + k;
      }
    }
  }
}

// The window's sweep with R rays a thread and S lanes a ray: the packed
// list's entry e of chain r of lane `lane` in warp w is w * (32 R / S) +
// r * (32 / S) + lane / S (a ray's S lanes adjacent), for e < live (past
// it the chain repeats the last entry and writes nothing).  Tile 0 is in
// flight.
template <int R, int S>
__device__ __forceinline__ void sweep_window(const Scene& sc,
                                             const Rays& rays,
                                             const int* list, int live,
                                             int64_t base, float* raw,
                                             float4* tile) {
  constexpr int kPerWarp = 32 * R / S;  // entries a warp
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = lane % S;  // this lane's part of its ray's sweep
  V3 o[R], d[R];
  float bt[R];
  int bp[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    e[r] = w * kPerWarp + r * (32 / S) + lane / S;
    const int64_t i = base + list[imin(e[r], live - 1)];
    o[r] = load3(rays.origin, i);
    d[r] = load3(rays.direction, i);
    bt[r] = kBig;
    bp[r] = 0;
  }
  const bool busy = w * kPerWarp < live;  // the warp has a live entry
  const int tiles = sphere_tiles(sc) + (sc.nt + kTriangleTile - 1) /
                                           kTriangleTile;
  for (int j = 0; j < tiles; ++j) {
    wait_copies<0>();
    __syncthreads();  // tile j's rows have landed; tile j - 1 is swept
    const int m = rewrite(sc, j, raw, tile);
    __syncthreads();  // tile j is written; the raw rows are free
    if (j + 1 < tiles) stage(sc, j + 1, raw);
    commit_copies();
    if (!busy) continue;
    if (j < sphere_tiles(sc))
      sweep_spheres<R, S>(tile, m, j * kSphereTile, o, d, rays.t_min, bt,
                          bp, part);
    else
      sweep_triangles<R, S>(tile, m,
                            sc.ns + (j - sphere_tiles(sc)) * kTriangleTile,
                            o, d, rays.t_min, bt, bp, part);
  }
  if (!busy) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int x = 1; x < S; x <<= 1) {  // the (t, global id) minimum
      const float t = __shfl_xor_sync(0xffffffffu, bt[r], x);
      const int p = __shfl_xor_sync(0xffffffffu, bp[r], x);
      if (t < bt[r] || (t == bt[r] && p < bp[r])) {
        bt[r] = t;
        bp[r] = p;
      }
    }
    if (part == 0 && e[r] < live) {
      const int64_t i = base + list[e[r]];
      rays.prim[i] = bp[r];
      rays.t[i] = bt[r];
      rays.hit[i] = bt[r] < kBig;
    }
  }
}

// The window's sweep of its `live` rays, at most kThreads, one ray over S
// lanes: S the largest power of two up to kMaxSplit with live * S <=
// kThreads.
template <int S>
__device__ __forceinline__ void sweep_split(const Scene& sc,
                                            const Rays& rays,
                                            const int* list, int live,
                                            int64_t base, float* raw,
                                            float4* tile) {
  if constexpr (S < kMaxSplit) {
    if (2 * S * live <= kThreads)
      return sweep_split<2 * S>(sc, rays, list, live, base, raw, tile);
  }
  sweep_window<1, S>(sc, rays, list, live, base, raw, tile);
}

__global__ void __launch_bounds__(kThreads)
    dense_hit_kernel(Scene sc, Rays rays) {
  extern __shared__ float4 dense_shared[];
  float4* tile = dense_shared;
  float* raw = reinterpret_cast<float*>(tile + tile_vecs(sc.ns, sc.nt));
  int* list = reinterpret_cast<int*>(tile + tile_vecs(sc.ns, sc.nt) +
                                     raw_vecs(sc.ns, sc.nt));
  int* counts = list + kWindow;  // [r * kWarps + w]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kWindow;

  // The window's liveness, its live rays packed, in order, into the list.
  bool live[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    live[r] = i < rays.n &&
              (rays.alive == nullptr || __ldg(rays.alive + i) != 0);
  }
  unsigned ballot[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    ballot[r] = __ballot_sync(0xffffffffu, live[r]);
    if (lane == 0) counts[r * kWarps + w] = __popc(ballot[r]);
  }
  __syncthreads();
  int total = 0, before[kRays] = {};
  for (int q = 0; q < kRays * kWarps; ++q) {
#pragma unroll
    for (int r = 0; r < kRays; ++r)
      if (q < r * kWarps + w) before[r] += counts[q];
    total += counts[q];
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (live[r]) {
      list[before[r] + __popc(ballot[r] & ((1u << lane) - 1u))] =
          r * kThreads + threadIdx.x;
    } else if (i < rays.n) {  // dead: the miss
      rays.prim[i] = 0;
      rays.t[i] = kBig;
      rays.hit[i] = 0;
    }
  }
  if (total == 0) return;  // the whole block: no live ray, no scene
  stage(sc, 0, raw);
  commit_copies();
  __syncthreads();  // the list is written
  if (total > kThreads)
    sweep_window<kRays, 1>(sc, rays, list, total, base, raw, tile);
  else
    sweep_split<1>(sc, rays, list, total, base, raw, tile);
}

}  // namespace

extern "C" {

// Launches K11 on `stream` over n rays (module comment): the scene's
// sph_center (ns, 3), sph_radius (ns,), tri_v0, tri_v1, tri_v2 (nt, 3), all
// float32; the rays' origin and direction (n, 3) float32, their liveness
// alive (n,) bool (null: every ray live) and t_min; writes prim (n,) int32,
// t (n,) float32 and hit (n,) bool.  Launches nothing for n = 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
int frt_dense_hit(const float* sph_center, const float* sph_radius,
                  const float* tri_v0, const float* tri_v1,
                  const float* tri_v2, int ns, int nt, const float* origin,
                  const float* direction, const uint8_t* alive, int64_t n,
                  float t_min, int* prim, float* t, uint8_t* hit,
                  void* stream) {
  if (n > 0) {
    const Scene sc{sph_center, sph_radius, tri_v0, tri_v1, tri_v2, ns, nt};
    const Rays rays{origin, direction, alive, n, t_min, prim, t, hit};
    const int blocks = static_cast<int>((n + kWindow - 1) / kWindow);
    dense_hit_kernel<<<blocks, kThreads, dense_smem_bytes(ns, nt),
                       static_cast<cudaStream_t>(stream)>>>(sc, rays);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
