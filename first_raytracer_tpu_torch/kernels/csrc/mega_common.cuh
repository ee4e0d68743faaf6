// Device code shared by the megakernel (K1, and K2 = K1 with a tape), the
// standalone tape recorder (K2b) and the clustered megakernel (K3, K3t): the
// Threefry stream, the thin-lens camera ray, the dense sweep with exact
// closest-hit selection, the shading of one segment, and the two loops that
// drive paths through them, both run by persistent warps that take work
// from a launch-wide counter: `render_warp` (K1, K2, K3), where a warp's
// lanes take the next unstarted (pixel, sample) as their paths end and
// each pixel is summed in sample order, and `record_warp` (K2b, K3t), where
// they take the next unstarted ray id of the warp's window and each ray
// writes its own tape column.  Both are templated over the scene's
// closest-hit routine (DenseScene here, ClusterScene in
// megakernel_clustered.cu), so the recorded tapes cannot drift from the
// rendered paths and a clustered path is shaded by the same code as a dense
// one.  Every lane of a warp calls the closest hit at the same step (an idle
// lane with `active` false), so a scene sweeps with the whole warp: the
// clustered sweep splits each opened cluster's (ray, cluster) pairs over
// the warp (and K3t's walks its few live rays' gates together), the dense
// one each live ray's primitives over the idle lanes.
//
// Dense scene tables (built on the host by
// kernels/megakernel.py::pack_scene_mega, primitives sorted into six
// (material, texture) groups):
//   sph (16, ns_pad) plane-major: 0-2 center, 3 radius, 4 param (fuzz |
//       ref_idx), 5-7 albedo, 8-10 albedo2, 11 tex_scale, 12 c0, 13 original
//       id, 15 1/radius;
//   mx  (ns_pad, 8): cx cy cz c0 (the JAX kernel's row, unused here), then
//       cx cy cz r, the row the sphere root reads (r NaN in padding rows).
//   tri (24, nt_pad) plane-major: 0-2 v0, 3-5 e1, 6-8 e2, 9-11 unit normal,
//       12 param, 13-15 albedo, 16-18 albedo2, 19 tex_scale, 20 original id.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

#include <cstddef>
#include <cstdint>

namespace frt {

constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.283185307179586f;

struct Tables {
  const float* cam;   // (20,): origin, lower_left, horizontal, vertical,
                      // lens u, lens v, lens radius, pad
  const float* sph;   // (16, ns_pad)
  const float4* mx;   // (ns_pad, 2) float4 = (ns_pad, 8) floats; the
                      // second float4 of a row is (cx, cy, cz, r)
  const float* tri;   // (24, nt_pad)
  int ns, nt, ns_pad, nt_pad;
  int sph_groups[7];  // cumulative starts of the six groups, then total
  int tri_groups[7];
};

// What every path of a launch shares.
struct PathParams {
  uint32_t k0, k1;  // Threefry key words
  int nx, ny;
  int max_depth;
  float t_min;
};

struct CameraRow {
  float co_x, co_y, co_z, ll_x, ll_y, ll_z, hz_x, hz_y, hz_z;
  float vt_x, vt_y, vt_z, lu_x, lu_y, lu_z, lv_x, lv_y, lv_z, lens_r;
};

inline Tables make_tables(const float* cam, const float* sph, const float* mx,
                          const float* tri, int ns, int nt, int ns_pad,
                          int nt_pad, const int* groups) {
  Tables tb;
  tb.cam = cam;
  tb.sph = sph;
  tb.mx = reinterpret_cast<const float4*>(mx);
  tb.tri = tri;
  tb.ns = ns;
  tb.nt = nt;
  tb.ns_pad = ns_pad;
  tb.nt_pad = nt_pad;
  for (int k = 0; k < 7; ++k) {
    tb.sph_groups[k] = groups[k];
    tb.tri_groups[k] = groups[7 + k];
  }
  return tb;
}

__device__ __forceinline__ CameraRow load_camera(const float* __restrict__ c) {
  return CameraRow{c[0],  c[1],  c[2],  c[3],  c[4],  c[5],  c[6],
                   c[7],  c[8],  c[9],  c[10], c[11], c[12], c[13],
                   c[14], c[15], c[16], c[17], c[18]};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32-20, as first_raytracer_tpu/core/rng.py::_threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[(4 * g + j) % 8]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// The four uniforms of RNG domain `dom` for ray `id`: counters (id, 2 dom)
// and (id, 2 dom + 1).
__device__ __forceinline__ void draws4(uint32_t k0, uint32_t k1, uint32_t id,
                                       uint32_t dom, float u[4]) {
  uint32_t a0, a1, b0, b1;
  threefry2x32(k0, k1, id, 2u * dom, a0, a1);
  threefry2x32(k0, k1, id, 2u * dom + 1u, b0, b1);
  u[0] = unit_float(a0);
  u[1] = unit_float(a1);
  u[2] = unit_float(b0);
  u[3] = unit_float(b1);
}

// vecmath.normalize: zero where the (floored) squared length is not > 0.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z,
                                           float eps) {
  float n2 = x * x + y * y + z * z;
  if (eps > 0.0f) n2 = fmaxf(n2, eps);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
  x *= inv;
  y *= inv;
  z *= inv;
}

// Material and texture type of sorted primitive `w` from its group ranges
// (starts g1..g6; g0 = 0).  The bounds come by value: taking the address of
// a kernel parameter array would copy it to local memory.
__device__ __forceinline__ void group_types(int w, int g1, int g2, int g3,
                                            int g4, int g5, int g6,
                                            bool& metal, bool& diel,
                                            bool& check) {
  metal = w >= g2 && w < g4;
  diel = w >= g4 && w < g6;
  check = (w >= g1 && w < g2) || (w >= g3 && w < g4) || (w >= g5 && w < g6);
}

// Thin-lens camera ray (render/camera.py::generate_rays) of pixel column
// `fi`, bottom-up row `fj`, from the camera-domain draws `u`.
__device__ __forceinline__ void camera_ray(const CameraRow& c, float fi,
                                           float fj, int nx, int ny,
                                           const float u[4], float& ox,
                                           float& oy, float& oz, float& dx,
                                           float& dy, float& dz) {
  const float fs = (fi + u[0]) / static_cast<float>(nx);
  const float ft = (fj + u[1]) / static_cast<float>(ny);
  const float lr = sqrtf(u[2]);
  const float th = kTwoPi * u[3];
  const float rd0 = c.lens_r * (lr * cosf(th));
  const float rd1 = c.lens_r * (lr * sinf(th));
  const float off_x = rd0 * c.lu_x + rd1 * c.lv_x;
  const float off_y = rd0 * c.lu_y + rd1 * c.lv_y;
  const float off_z = rd0 * c.lu_z + rd1 * c.lv_z;
  ox = c.co_x + off_x;
  oy = c.co_y + off_y;
  oz = c.co_z + off_z;
  dx = c.ll_x + fs * c.hz_x + ft * c.vt_x - c.co_x - off_x;
  dy = c.ll_y + fs * c.hz_y + ft * c.vt_y - c.co_y - off_y;
  dz = c.ll_z + fs * c.hz_z + ft * c.vt_z - c.co_z - off_z;
  normalize3(dx, dy, dz, 0.0f);
}

// The closest hit of a segment: t (kBig on a miss), the sphere and the
// triangle winner (columns of the scene's tables) and which of them won.
struct Hit {
  float t;
  int w_s, w_t;
  bool is_tri;
};

// The winner's surface at the hit point, read from its payload row.
struct Surface {
  float nx, ny, nz, param, a0r, a0g, a0b, a1r, a1g, a1b, tsc;
  bool metal, diel, check;
};

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpSize = 32;
constexpr int kSphereCap = 1024;  // spheres a dense block stages (16 KB)
constexpr int kTriCap = 512;      // triangles a dense block stages (18 KB)
constexpr int kGroup = 4;  // spheres whose discriminants share a branch

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The lexicographic (t, column) fold of a hit into a running winner.
__device__ __forceinline__ void fold_lex(float t, int w, float& t_best,
                                         int& w_best) {
  if (t < t_best || (t == t_best && w < w_best)) {
    t_best = t;
    w_best = w;
  }
}

// The lane of the g-th set bit of `mask`.
__device__ __forceinline__ int nth_lane(unsigned mask, int g) {
  for (int i = 0; i < g; ++i) mask &= mask - 1u;
  return __ffs(static_cast<int>(mask)) - 1;
}

// Lanes that share one ray's sweep when k lanes of the warp need one: the
// largest power of two S with k * S <= 32, at most `most`.
__device__ __forceinline__ int lanes_per_ray(int k, int most) {
  int split = 1;
  while (split < most && 2 * split * k <= kWarpSize) split *= 2;
  return split;
}

// The sphere root of every megakernel.  For the kGroup spheres s[g] = (cx,
// cy, cz, r) numbered base + g: b = d.(o - C), c = (o - C).(o - C) - r^2,
// the discriminant b^2 - c and the roots -b -+ sqrt(b^2 - c), all in double
// from the float inputs (nvcc --fmad=false leaves them uncontracted), each
// root rounded once to float and passed to fold(t, base + g).  The JAX
// kernels' expanded quadratic (c = |o|^2 - 2 o.C + |C|^2 - r^2 in float)
// cancels |o|^2 against 2 o.C far from the origin, and a float
// discriminant cancels b^2 against c there (b^2 ~ 8,000 on field20000):
// either puts a hit point up to ~1e-3 off the surface, so that a bounce
// ray re-hit its own sphere just past t_min.  A root in double puts it
// within a float rounding of the surface.
//
// A sphere reaches the doubles only past a float prefilter, the same
// oc-form in float: disc' = b'^2 - (|o - C|^2 - r^2) is within about 17 u
// (b^2 + |o - C|^2 + r^2) of the exact discriminant (u = 2^-24), and b^2 <=
// |d|^2 |o - C|^2, so a sphere with disc' < -slack (|o - C|^2 + r^2), slack
// = 2^-16 (|d|^2 + 1), has no root (the margin is 15 times that error): a
// miss costs 20 float operations and a compare, and the doubles, the branch
// and the roots are paid once a group, by the spheres past the prefilter,
// those whose line the ray nearly meets.  This holds while the squares stay
// finite and normal in float (|o - C| and |r| below 2^60, |r| above
// 2^-40).  A padding row (any centre, radius NaN) fails the prefilter and
// would fail the root too.
constexpr float kSlack = 1.0f / 65536.0f;

__device__ __forceinline__ float sphere_slack(float dx, float dy, float dz) {
  return kSlack * (dx * dx + dy * dy + dz * dz + 1.0f);
}

template <class Fold>
__device__ __forceinline__ void sphere_group(const float4 (&s)[kGroup],
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float slack, float t_min,
                                             int base, Fold fold) {
  bool maybe[kGroup];
  bool any = false;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const float px = ox - s[g].x, py = oy - s[g].y, pz = oz - s[g].z;
    const float bp = dx * px + dy * py + dz * pz;
    const float pp = px * px + py * py + pz * pz;
    const float rr = s[g].w * s[g].w;
    maybe[g] = bp * bp - (pp - rr) >= -slack * (pp + rr);
    any |= maybe[g];
  }
  if (!any) return;
  const double ox64 = ox, oy64 = oy, oz64 = oz;
  const double dx64 = dx, dy64 = dy, dz64 = dz;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (!maybe[g]) continue;
    const double px = ox64 - static_cast<double>(s[g].x);
    const double py = oy64 - static_cast<double>(s[g].y);
    const double pz = oz64 - static_cast<double>(s[g].z);
    const double r = s[g].w;
    const double bq = dx64 * px + dy64 * py + dz64 * pz;
    const double cq = px * px + py * py + pz * pz - r * r;
    const double disc = bq * bq - cq;
    if (!(disc >= 0.0)) continue;  // no root (or NaN): a miss
    const double sq = sqrt(disc);
    const float tn = static_cast<float>(-bq - sq);
    const float tf = static_cast<float>(sq - bq);
    fold(tn > t_min ? tn : (tf > t_min ? tf : kBig), base + g);
  }
}

// Moller-Trumbore on prepacked edges: true with t on a hit.
__device__ __forceinline__ bool triangle_hit(float v0x, float v0y, float v0z,
                                             float e1x, float e1y, float e1z,
                                             float e2x, float e2y, float e2z,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_min, float& t) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-9f)) return false;
  const float inv = 1.0f / det;
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float uu = (tvx * px + tvy * py + tvz * pz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float vv = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && t > t_min &&
         t < kBig;
}

// The dense scene of K1, K2 and K2b.  Its first kSphereCap spheres, as
// (cx, cy, cz, r) rows padded to a whole group, and the planes v0, e1, e2
// of its first kTriCap triangles are staged once per block in shared
// memory (`stage`); a larger scene's remaining primitives are read from
// device memory, after the staged ones, so the sweep keeps index order.
//
// The sweep is the warp's: with k lanes live, each live ray's sphere
// groups and triangles are split over S = 32 / k lanes (rounded down to a
// power of two), and the S partial winners of each primitive type
// meet in a warp-shuffle lexicographic minimum of (t, column), as K3
// splits a cluster's members.  The winner is the one a lane's own sweep in
// index order picks, so the split is exact; with one lane live its path's
// segment costs about a 32nd of a sweep.  With more than 16 live (S = 1)
// each live lane sweeps its own ray.  K2b's tail, where a launch of 2^17
// rays waits on its deepest paths, needs it; K1 measured 13.2-13.5 ms
// with it against 13.9-14.3 without (probes/mega_grid.py, PERF.md).
struct DenseScene {
  Tables tb;
  const float4* srow = nullptr;  // staged sphere rows
  const float* tpl = nullptr;    // staged triangle planes, pitch tpitch
  int ns_tile = 0, nt_tile = 0, tpitch = 0;

  // Nothing is counted in the dense sweep.
  struct Counters {
    static constexpr int kLane = 0;
    int warp_clusters = 0;
    __device__ __forceinline__ void flush(int*) {}
    __device__ __forceinline__ void store(int*) {}
  };

  // Bytes of shared memory `stage` takes for ns spheres and nt triangles.
  __host__ __device__ static constexpr int smem_bytes(int ns, int nt) {
    return 16 * round4(ns < kSphereCap ? ns : kSphereCap) +
           4 * 9 * round4(nt < kTriCap ? nt : kTriCap);
  }

  // Every thread of the block calls this once; the rows are in place for
  // every thread when it returns.
  __device__ void stage(unsigned char* smem) {
    ns_tile = tb.ns < kSphereCap ? tb.ns : kSphereCap;
    nt_tile = tb.nt < kTriCap ? tb.nt : kTriCap;
    tpitch = round4(nt_tile);
    float4* rows = reinterpret_cast<float4*>(smem);
    float* planes = reinterpret_cast<float*>(rows + round4(ns_tile));
    for (int k = threadIdx.x; k < round4(ns_tile); k += blockDim.x) {
      if (k < ns_tile)
        copy16_async(rows + k, tb.mx + 2 * k + 1);
      else
        rows[k] = make_float4(0.0f, 0.0f, 0.0f, NAN);
    }
    // Whole 16-byte runs of each plane, inside the pack's padding.
    for (int q = threadIdx.x; q < 9 * (tpitch / 4); q += blockDim.x) {
      const int p = q / (tpitch / 4), k = 4 * (q % (tpitch / 4));
      copy16_async(planes + p * tpitch + k, tb.tri + p * tb.nt_pad + k);
    }
    commit_copies();
    wait_copies<0>();
    __syncthreads();
    srow = rows;
    tpl = planes;
  }

  // Sphere groups sub, sub + split, ... and triangles sub, sub + split, ...
  // against the ray o + t d, each type folded in index order (the lowest
  // column wins a tie): (t_s, w_s) and (t_t, w_t), kBig and 0 on a miss.
  __device__ __forceinline__ void sweep(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float t_min, int sub, int split,
                                        float& t_s, int& w_s, float& t_t,
                                        int& w_t) const {
    const float slack = sphere_slack(dx, dy, dz);
    auto fold_s = [&](float t, int i) {
      if (t < t_s) {  // strict: the lowest index wins a tie
        t_s = t;
        w_s = i;
      }
    };
    for (int k = kGroup * sub; k < ns_tile; k += kGroup * split) {
      const float4 s[kGroup] = {srow[k], srow[k + 1], srow[k + 2],
                                srow[k + 3]};
      sphere_group(s, ox, oy, oz, dx, dy, dz, slack, t_min, k, fold_s);
    }
    // Past the staged rows: device memory, whose rows past ns are never
    // hit either.
    for (int k = ns_tile + kGroup * sub; k < tb.ns; k += kGroup * split) {
      const float4 s[kGroup] = {
          __ldg(&tb.mx[2 * k + 1]), __ldg(&tb.mx[2 * k + 3]),
          __ldg(&tb.mx[2 * k + 5]), __ldg(&tb.mx[2 * k + 7])};
      sphere_group(s, ox, oy, oz, dx, dy, dz, slack, t_min, k, fold_s);
    }
    const int tp = tpitch;
    for (int i = sub; i < nt_tile; i += split) {
      float t;
      if (triangle_hit(tpl[i], tpl[tp + i], tpl[2 * tp + i], tpl[3 * tp + i],
                       tpl[4 * tp + i], tpl[5 * tp + i], tpl[6 * tp + i],
                       tpl[7 * tp + i], tpl[8 * tp + i], ox, oy, oz, dx, dy,
                       dz, t_min, t) &&
          t < t_t) {
        t_t = t;
        w_t = i;
      }
    }
    const float* __restrict__ tri = tb.tri;
    const int gp = tb.nt_pad;
    for (int i = nt_tile + sub; i < tb.nt; i += split) {
      float t;
      if (triangle_hit(__ldg(&tri[i]), __ldg(&tri[gp + i]),
                       __ldg(&tri[2 * gp + i]), __ldg(&tri[3 * gp + i]),
                       __ldg(&tri[4 * gp + i]), __ldg(&tri[5 * gp + i]),
                       __ldg(&tri[6 * gp + i]), __ldg(&tri[7 * gp + i]),
                       __ldg(&tri[8 * gp + i]), ox, oy, oz, dx, dy, dz,
                       t_min, t) &&
          t < t_t) {
        t_t = t;
        w_t = i;
      }
    }
  }

  // Exact (min t, lowest sorted index) selection over every sphere and
  // triangle; a sphere wins a sphere/triangle tie.  Every lane of the warp
  // calls it, and h is set on the live (`active`) lanes only.
  __device__ __forceinline__ void closest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, bool active, Hit& h,
                                          Counters&) const {
    float t_s = kBig, t_t = kBig;
    int w_s = 0, w_t = 0;
    const unsigned live = __ballot_sync(kFullMask, active);
    const int split = lanes_per_ray(__popc(live), kWarpSize);
    if (split == 1) {
      if (!active) return;
      sweep(ox, oy, oz, dx, dy, dz, t_min, 0, 1, t_s, w_s, t_t, w_t);
    } else {
      // Lane g * split + sub takes share sub of the ray of the g-th live
      // lane.
      const int lane = threadIdx.x % kWarpSize;
      const int g = lane / split;
      const bool mine = g < __popc(live);
      const int src = mine ? nth_lane(live, g) : lane;
      const float rox = __shfl_sync(kFullMask, ox, src);
      const float roy = __shfl_sync(kFullMask, oy, src);
      const float roz = __shfl_sync(kFullMask, oz, src);
      const float rdx = __shfl_sync(kFullMask, dx, src);
      const float rdy = __shfl_sync(kFullMask, dy, src);
      const float rdz = __shfl_sync(kFullMask, dz, src);
      if (mine)
        sweep(rox, roy, roz, rdx, rdy, rdz, t_min, lane % split, split, t_s,
              w_s, t_t, w_t);
      for (int o = 1; o < split; o <<= 1) {  // the ray's split partials
        const float ts = __shfl_xor_sync(kFullMask, t_s, o);
        const int ws = __shfl_xor_sync(kFullMask, w_s, o);
        const float tt = __shfl_xor_sync(kFullMask, t_t, o);
        const int wt = __shfl_xor_sync(kFullMask, w_t, o);
        fold_lex(ts, ws, t_s, w_s);
        fold_lex(tt, wt, t_t, w_t);
      }
      // Each live lane takes its ray's winners from the first lane of its
      // share: its rank among the live lanes, times the split.
      const int rank = __popc(live & ((1u << lane) - 1u));
      const int from = active ? rank * split : lane;
      t_s = __shfl_sync(kFullMask, t_s, from);
      w_s = __shfl_sync(kFullMask, w_s, from);
      t_t = __shfl_sync(kFullMask, t_t, from);
      w_t = __shfl_sync(kFullMask, w_t, from);
    }
    h.w_s = w_s;
    h.w_t = w_t;
    h.is_tri = t_t < t_s;
    h.t = h.is_tri ? t_t : t_s;
  }

  // The winner's original scene id (payload row 13 / 20).
  __device__ __forceinline__ int original_id(const Hit& h) const {
    return static_cast<int>(h.is_tri ? tb.tri[20 * tb.nt_pad + h.w_t]
                                     : tb.sph[13 * tb.ns_pad + h.w_s]);
  }

  // Material and texture types follow from the winner's group range.
  __device__ __forceinline__ void surface(const Hit& h, float hx, float hy,
                                          float hz, Surface& f) const {
    const float* __restrict__ sph = tb.sph;
    const float* __restrict__ tri = tb.tri;
    const int sp = tb.ns_pad, tp = tb.nt_pad;
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
      group_types(w, tb.tri_groups[1], tb.tri_groups[2], tb.tri_groups[3],
                  tb.tri_groups[4], tb.tri_groups[5], tb.tri_groups[6],
                  f.metal, f.diel, f.check);
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
      group_types(w, tb.sph_groups[1], tb.sph_groups[2], tb.sph_groups[3],
                  tb.sph_groups[4], tb.sph_groups[5], tb.sph_groups[6],
                  f.metal, f.diel, f.check);
    }
  }
};

// One path between segments: its ray, throughput and depth.
struct PathState {
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float tp_r = 1.0f, tp_g = 1.0f, tp_b = 1.0f;
  uint32_t rid = 0;
  int depth = 0;
};

// The camera ray of ray `rid` of the pixel at column `fi`, bottom-up row
// `fj`.
__device__ __forceinline__ void start_path(const CameraRow& cam,
                                           const PathParams& pp, uint32_t rid,
                                           float fi, float fj,
                                           PathState& st) {
  float u[4];
  draws4(pp.k0, pp.k1, rid, 0u, u);  // camera domain
  camera_ray(cam, fi, fj, pp.nx, pp.ny, u, st.ox, st.oy, st.oz, st.dx, st.dy,
             st.dz);
  st.tp_r = st.tp_g = st.tp_b = 1.0f;
  st.rid = rid;
  st.depth = 0;
}

// One segment of a path whose closest hit is `h`: on a miss the sky (its
// radiance in r, g, b with kRadiance), else the scatter, and true when the
// path ends here (a miss, absorbed, or at the depth cap; r, g, b stay 0 but
// for the sky).  With kTape row `depth` of the path's tape column
// (`tape[depth * stride]`) gets the original scene id of the primitive hit,
// or -1, and a path that ends fills its rows past `depth` with -1.
template <bool kRadiance, bool kTape, class Scene>
__device__ __forceinline__ bool segment(const Scene& scene,
                                        const PathParams& pp, const Hit& h,
                                        PathState& st, float& r, float& g,
                                        float& b, int* __restrict__ tape,
                                        size_t stride) {
  const int depth = st.depth;
  const float dx = st.dx, dy = st.dy, dz = st.dz;
  bool ended;
  const float t_best = h.t;
  if (!(t_best < kBig)) {  // miss: sky, white -> blue by height
    if (kRadiance) {
      const float skyt = 0.5f * (dy + 1.0f);
      r = st.tp_r * ((1.0f - skyt) + skyt * 0.5f);
      g = st.tp_g * ((1.0f - skyt) + skyt * 0.7f);
      b = st.tp_b * ((1.0f - skyt) + skyt * 1.0f);
    }
    if (kTape) tape[depth * stride] = -1;
    ended = true;
  } else {
    if (kTape) tape[depth * stride] = scene.original_id(h);

    // Hit record and the winner's material, read from its payload row.
    const float hx = st.ox + t_best * dx;
    const float hy = st.oy + t_best * dy;
    const float hz = st.oz + t_best * dz;
    Surface f;
    scene.surface(h, hx, hy, hz, f);
    const float nx = f.nx, ny = f.ny, nz = f.nz, param = f.param;

    // Bounce-domain draws: unit-ball sample and the dielectric coin.
    float u[4];
    draws4(pp.k0, pp.k1, st.rid, static_cast<uint32_t>(depth + 1), u);
    const float bz = 1.0f - 2.0f * u[0];
    const float br = sqrtf(fmaxf(0.0f, 1.0f - bz * bz));
    const float phi = kTwoPi * u[1];
    // The cube root in f64, rounded once to f32: the correctly rounded
    // cbrt, which the plain version computes too (cbrtf is within an ulp,
    // and one ulp can send a path another way).
    const float brad = static_cast<float>(cbrt(static_cast<double>(u[2])));
    const float bx = brad * (br * cosf(phi));
    const float by = brad * (br * sinf(phi));
    const float bzz = brad * bz;
    const float coin = u[3];

    const float ddn = dx * nx + dy * ny + dz * nz;
    const float refx = dx - 2.0f * ddn * nx;
    const float refy = dy - 2.0f * ddn * ny;
    const float refz = dz - 2.0f * ddn * nz;
    float ndx, ndy, ndz;
    bool scattered = true;
    float att_r = 1.0f, att_g = 1.0f, att_b = 1.0f;
    if (f.diel) {
      // Snell with the TIR check; Schlick with the reference's
      // cosine = ref_idx * dot(d, N) when exiting.
      const bool outside = ddn > 0.0f;
      const float own_x = outside ? -nx : nx;
      const float own_y = outside ? -ny : ny;
      const float own_z = outside ? -nz : nz;
      const float ni = outside ? param : 1.0f / param;
      const float cosine = outside ? param * ddn : -ddn;
      float uvx = dx, uvy = dy, uvz = dz;
      normalize3(uvx, uvy, uvz, 0.0f);
      const float dt = uvx * own_x + uvy * own_y + uvz * own_z;
      const float disc2 = 1.0f - ni * ni * (1.0f - dt * dt);
      const bool can = disc2 > 0.0f;
      float r0 = (1.0f - param) / (1.0f + param);
      r0 = r0 * r0;
      const float om = 1.0f - cosine;
      const float om2 = om * om;
      const float schl = r0 + (1.0f - r0) * (om2 * om2 * om);
      const float rprob = can ? schl : 1.0f;
      if (coin < rprob) {
        ndx = refx;
        ndy = refy;
        ndz = refz;
      } else {
        const float sq2 = sqrtf(disc2);
        ndx = ni * (uvx - own_x * dt) - own_x * sq2;
        ndy = ni * (uvy - own_y * dt) - own_y * sq2;
        ndz = ni * (uvz - own_z * dt) - own_z * sq2;
      }
    } else {
      if (f.metal) {
        ndx = refx + param * bx;
        ndy = refy + param * by;
        ndz = refz + param * bzz;
        scattered = (ndx * nx + ndy * ny + ndz * nz) > 0.0f;
      } else {
        ndx = nx + bx;
        ndy = ny + by;
        ndz = nz + bzz;
      }
      if (kRadiance) {
        bool odd = false;
        if (f.check) {
          odd = sinf(f.tsc * hx) * sinf(f.tsc * hy) * sinf(f.tsc * hz) < 0.0f;
        }
        att_r = odd ? f.a1r : f.a0r;
        att_g = odd ? f.a1g : f.a0g;
        att_b = odd ? f.a1b : f.a0b;
      }
    }
    // Every scattered direction is made a unit vector, the dielectric's
    // too (materials/scatter.py's rule): the sphere root takes |d| = 1,
    // and a reflection or refraction off a hit point a little off the
    // surface (a short normal) is not one.
    normalize3(ndx, ndy, ndz, 1e-20f);
    // Absorbed (metal below the surface) or at the depth cap: black.
    ended = !scattered || depth >= pp.max_depth;
    if (!ended) {
      st.tp_r *= att_r;
      st.tp_g *= att_g;
      st.tp_b *= att_b;
      st.ox = hx;
      st.oy = hy;
      st.oz = hz;
      st.dx = ndx;
      st.dy = ndy;
      st.dz = ndz;
      st.depth = depth + 1;
    }
  }
  if (kTape && ended) {
    for (int d = depth + 1; d <= pp.max_depth; ++d) tape[d * stride] = -1;
  }
  return ended;
}

// What one launch of K1, K2 or K3 renders: `num_pixels` pixels from global
// pixel `pix0` (of `total_pixels`), samples spp0 .. spp0 + spp - 1 of a
// `spp_total`-sample render, `chunk` samples of a pixel at a time.  `work`
// counts the groups of 32 pixels handed out to warps; it is 0 when the
// launch starts.
struct RenderLaunch {
  int spp, spp_total, spp0, pix0, num_pixels, total_pixels, chunk;
  int* work;
};

constexpr int kRenderThreads = 128;
constexpr int kRenderWarps = kRenderThreads / kWarpSize;

// The groups of 32 pixels a render of `num_pixels` hands out to warps.
__host__ __device__ constexpr int pixel_groups(int num_pixels) {
  return (num_pixels + kWarpSize - 1) / kWarpSize;
}

// Bytes of a warp's shared store in render_warp: two slots, each the
// radiance of `chunk` samples of 32 pixels; two groups' segment counts and
// `lane` counters per pixel; the warp's first group (4 ints).
__host__ __device__ constexpr int warp_store_bytes(int chunk, int lane) {
  return 4 * (2 * kWarpSize * (3 * chunk + 1 + lane) + 4);
}

// K1, K2 and K3.  The launch's pixels are cut into groups of 32, each
// group's samples into chunks of `chunk`; a (group, chunk) is a unit of
// work.  A warp takes groups from the launch-wide counter `work`, and
// keeps a window of two units: its lanes take the next unstarted (pixel,
// sample) of the window, in lane order (__ballot_sync, __popc), at points
// where the whole warp is converged, so a warp's lanes stay busy until the
// launch runs out of work rather than until its pixels' longest path is
// done.  Each sample's radiance goes to the unit's slot in the warp's
// shared store; when a unit's paths are all done, its lanes add each
// pixel's samples in sample order to the pixel's sum (lane p holds pixel
// p of the group), and after a group's last chunk they write its pixels.
// So each sum is the one a thread tracing the pixel's samples in turn
// makes: the output does not depend on the schedule, and no float is
// added atomically (only the integer counts are).  `steps` (if not null)
// gets, at the first pixel of the warp's first group, the warp's segment
// steps, 0 at every other pixel; `sweeps` (if the scene counts) each
// pixel's counters, then the warp's swept clusters and steps as `steps`.
template <bool kTape, class Scene>
__device__ void render_warp(const Scene& scene, const CameraRow& cam,
                            const PathParams& pp, const RenderLaunch& ln,
                            unsigned char* store, float* __restrict__ rad,
                            int* __restrict__ segs, int* __restrict__ tape,
                            int* __restrict__ steps,
                            int* __restrict__ sweeps) {
  using Counters = typename Scene::Counters;
  constexpr int kLane = Counters::kLane;
  const int lane = threadIdx.x % kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  const int chunk = ln.chunk;
  float* rbuf = reinterpret_cast<float*>(
      store + warp * warp_store_bytes(chunk, kLane));
  int* pseg = reinterpret_cast<int*>(rbuf + 6 * kWarpSize * chunk);
  int* pcnt = pseg + 2 * kWarpSize;
  int* first = pcnt + 2 * kWarpSize * kLane;
  for (int k = lane; k < 2 * kWarpSize * (1 + kLane); k += kWarpSize)
    pseg[k] = 0;
  const int groups = pixel_groups(ln.num_pixels);
  // Pixels traced: a prefix of the launch's (its end, the image's).
  const int traced = min(ln.num_pixels, ln.total_pixels - ln.pix0);
  const int nchunks = (ln.spp + chunk - 1) / chunk;
  const size_t stride = static_cast<size_t>(ln.num_pixels) * ln.spp;
  auto valid = [&](int g) {  // traced pixels of group g
    return max(0, min(kWarpSize, traced - g * kWarpSize));
  };
  // The window, units [base, top): unit u in slot u & 1 is chunk cs & 0xffff
  // of group gs, the group's parity among the warp's groups in bit 16, with
  // ds of its paths done.  The next item to hand out is item si of unit su.
  int g0 = 0, g1 = 0, c0 = 0, c1 = 0, d0 = 0, d1 = 0;
  int base = 0, top = 0, su = 0, si = 0, taken_groups = 0;
  bool exhausted = false;
  auto items = [&](int s) {
    const int c = (s ? c1 : c0) & 0xffff;
    return valid(s ? g1 : g0) * min(chunk, ln.spp - c * chunk);
  };
  // Opens unit `top`: the next chunk of the last group, else a new group.
  auto open = [&]() {
    int g, c;
    const int last = (top - 1) & 1;
    if (top > 0 && ((last ? c1 : c0) & 0xffff) + 1 < nchunks) {
      g = last ? g1 : g0;
      c = (last ? c1 : c0) + 1;
    } else {
      if (exhausted) return false;
      int got = 0;
      if (lane == 0) got = atomicAdd(ln.work, 1);
      got = __shfl_sync(kFullMask, got, 0);
      if (got >= groups) {
        exhausted = true;
        return false;
      }
      if (taken_groups == 0 && lane == 0) first[0] = got;
      g = got;
      c = (taken_groups & 1) << 16;
      ++taken_groups;
    }
    if (top & 1) {
      g1 = g;
      c1 = c;
      d1 = 0;
    } else {
      g0 = g;
      c0 = c;
      d0 = 0;
    }
    ++top;
    return true;
  };

  bool live = false;
  int slot = 0, item = 0;  // this lane's path: item `item` of slot `slot`
  PathState st;
  int* col = nullptr;
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  Counters cnt;
  int nsteps = 0;
  __syncwarp();
  for (;;) {
    // Retire the oldest unit while all its paths are done.
    while (base < su) {
      const int s = base & 1;
      if ((s ? d1 : d0) != items(s)) break;
      __syncwarp();  // its paths' radiance is in the store
      const int g = s ? g1 : g0, cb = s ? c1 : c0;
      const int gp = cb >> 16, c = cb & 0xffff, nv = valid(g);
      const float* r = rbuf + s * 3 * kWarpSize * chunk;
      if (lane < nv) {
        for (int q = lane; q < items(s); q += nv) {  // in sample order
          sum_r += r[3 * q];
          sum_g += r[3 * q + 1];
          sum_b += r[3 * q + 2];
        }
      }
      if (c == nchunks - 1) {  // the group's last chunk: write its pixels
        const int loc = g * kWarpSize + lane;
        int* pc = pcnt + (gp * kWarpSize + lane) * kLane;
        if (loc < ln.num_pixels) {
          rad[3 * loc + 0] = sum_r;
          rad[3 * loc + 1] = sum_g;
          rad[3 * loc + 2] = sum_b;
          segs[loc] = pseg[gp * kWarpSize + lane];
          if (steps != nullptr) steps[loc] = 0;
          if (kLane > 0) {
            int* out = sweeps + static_cast<size_t>(kLane + 2) * loc;
            for (int k = 0; k < kLane; ++k) out[k] = pc[k];
            out[kLane] = 0;
            out[kLane + 1] = 0;
          }
          if (kTape && lane >= nv) {  // a pixel past the image: no path
            int* cl = tape + static_cast<size_t>(loc) * ln.spp;
            for (int q = 0; q < ln.spp; ++q) {
              for (int d = 0; d <= pp.max_depth; ++d) cl[d * stride + q] = -1;
            }
          }
        }
        pseg[gp * kWarpSize + lane] = 0;
        for (int k = 0; k < kLane; ++k) pc[k] = 0;
        sum_r = sum_g = sum_b = 0.0f;
      }
      __syncwarp();
      ++base;
    }
    // Hand the window's next items to the idle lanes, in lane order.
    const unsigned idle = __ballot_sync(kFullMask, !live);
    const int want = __popc(idle);
    const int rank = __popc(idle & ((1u << lane) - 1u));
    for (int given = 0; given < want;) {
      if (su == top) {
        if (top - base < 2 && open()) continue;
        break;
      }
      const int s = su & 1, n = items(s);
      const int take = min(n - si, want - given);
      if (!live && rank >= given && rank < given + take) {
        const int q = si + rank - given;
        const int g = s ? g1 : g0, nv = valid(g);
        const int p = q % nv;
        const int smp = ((s ? c1 : c0) & 0xffff) * chunk + q / nv;
        const int pix = ln.pix0 + g * kWarpSize + p;
        start_path(cam, pp,
                   static_cast<uint32_t>(pix) *
                           static_cast<uint32_t>(ln.spp_total) +
                       static_cast<uint32_t>(ln.spp0 + smp),
                   static_cast<float>(pix % pp.nx),
                   static_cast<float>(pix / pp.nx), st);
        if (kTape) {
          col = tape + static_cast<size_t>(g * kWarpSize + p) * ln.spp + smp;
        }
        live = true;
        slot = s;
        item = q;
      }
      given += take;
      si += take;
      if (si == n) {
        ++su;
        si = 0;
      }
    }
    if (!__any_sync(kFullMask, live)) {
      if (exhausted && base == top) break;
      continue;  // units without paths, retired on the next turn
    }
    ++nsteps;
    Hit h;
    scene.closest(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, pp.t_min, live,
                  h, cnt);
    bool ended = false;
    if (live) {
      float r = 0.0f, g = 0.0f, b = 0.0f;
      if (segment<true, kTape>(scene, pp, h, st, r, g, b, col, stride)) {
        float* out = rbuf + slot * 3 * kWarpSize * chunk + 3 * item;
        out[0] = r;
        out[1] = g;
        out[2] = b;
        const int cb = slot ? c1 : c0;
        const int pi = (cb >> 16) * kWarpSize + item % valid(slot ? g1 : g0);
        atomicAdd(&pseg[pi], st.depth + 1);
        cnt.flush(pcnt + pi * kLane);
        live = false;
        ended = true;
      }
    }
    const unsigned done = __ballot_sync(kFullMask, ended);
    const unsigned done1 = __ballot_sync(kFullMask, ended && slot == 1);
    d1 += __popc(done1);
    d0 += __popc(done) - __popc(done1);
  }
  if (taken_groups > 0 && lane == 0) {  // the warp's totals
    const int loc = first[0] * kWarpSize;
    if (steps != nullptr) steps[loc] = nsteps;
    if (kLane > 0) {
      int* out = sweeps + static_cast<size_t>(kLane + 2) * loc;
      out[kLane] = cnt.warp_clusters;
      out[kLane + 1] = nsteps;
    }
  }
}

// Opts a kernel in to more than 48 KB of dynamic shared memory.
template <class K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The blocks of a persistent launch of `kernel` with `smem` bytes of
// shared memory whose warps take `units` units of work from the launch's
// counter: as many as the card holds at once, but no more than the units
// need.
template <class K>
int render_blocks(K kernel, int smem, int units) {
  const int need = (units + kRenderWarps - 1) / kRenderWarps;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kRenderThreads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    return need;
  return need < sms * per_sm ? need : sms * per_sm;
}

// What one launch of K2b or K3t records: ray ids [ray0, ray0 + num_rays),
// ray id rid being sample rid % spp_total of pixel rid / spp_total.
// `work` counts the windows of kRecordWindow consecutive ray ids handed out
// to warps; it is 0 when the launch starts.
struct RecordLaunch {
  int ray0, num_rays, spp_total;
  int* work;
};

// Consecutive ray ids a warp takes from the launch's counter at a time.
// 16: at 2^17 rays a resident warp takes three (K2b) or four (K3t)
// windows; 32 and 64 were slower there, 4 and 8 no faster
// (probes/mega_grid.py, PERF.md).
constexpr int kRecordWindow = 16;

// K2b and K3t: the launch's warps each take windows of kRecordWindow ray
// ids from the counter `work`, and their lanes take the window's next
// unstarted id, in lane order (__ballot_sync, __popc), at points where the
// whole warp is converged, so a warp's lanes stay busy until the launch
// runs out of ids rather than until its deepest path ends.  Ray ray0 + i
// is column i of the (max_depth + 1, num_rays) tape; its lane writes the
// column's rows past the path's end (-1), `its[i]` (its segment count) and
// its counters when its path ends.  Each ray owns its column, so nothing
// depends on which lane traces it.  (One memset of the tape to -1 before
// the launch, the kernel writing only the rows paths reach, was no faster
// at 2^17 rays and 2% slower over the final scene's frame, where it
// writes 1.96 GB: the L2 cache merges the tails' scattered stores.)
// `steps` (if not null) gets the warp's segment steps at the first ray of
// its first window, 0 at every other ray; `sweeps` (if the scene counts)
// each ray's counters, then the warp's swept clusters and steps as
// `steps`.
template <class Scene>
__device__ void record_warp(const Scene& scene, const CameraRow& cam,
                            const PathParams& pp, const RecordLaunch& ln,
                            int* __restrict__ tape, int* __restrict__ its,
                            int* __restrict__ steps,
                            int* __restrict__ sweeps) {
  using Counters = typename Scene::Counters;
  constexpr int kLane = Counters::kLane;
  const int lane = threadIdx.x % kWarpSize;
  const int windows = (ln.num_rays + kRecordWindow - 1) / kRecordWindow;
  const size_t stride = static_cast<size_t>(ln.num_rays);
  int next = 0, end = 0;  // the window's unstarted ids: [next, end)
  int first = -1;         // the first id of the warp's first window
  bool exhausted = false;
  bool live = false;
  int i = 0;  // this lane's ray: ray0 + i
  PathState st;
  Counters cnt;
  int nsteps = 0;
  for (;;) {
    // Hand the next unstarted ids to the idle lanes, in lane order.
    const unsigned idle = __ballot_sync(kFullMask, !live);
    const int want = __popc(idle);
    const int rank = __popc(idle & ((1u << lane) - 1u));
    for (int given = 0; given < want;) {
      if (next == end) {
        if (exhausted) break;
        int got = 0;
        if (lane == 0) got = atomicAdd(ln.work, 1);
        got = __shfl_sync(kFullMask, got, 0);
        if (got >= windows) {
          exhausted = true;
          break;
        }
        next = got * kRecordWindow;
        end = min(next + kRecordWindow, ln.num_rays);
        if (first < 0) first = next;
      }
      const int take = min(end - next, want - given);
      if (!live && rank >= given && rank < given + take) {
        i = next + rank - given;
        const int rid = ln.ray0 + i;
        const int pix = rid / ln.spp_total;
        start_path(cam, pp, static_cast<uint32_t>(rid),
                   static_cast<float>(pix % pp.nx),
                   static_cast<float>(pix / pp.nx), st);
        live = true;
      }
      given += take;
      next += take;
    }
    if (!__any_sync(kFullMask, live)) break;  // no ids left, paths done
    ++nsteps;
    Hit h;
    scene.closest(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, pp.t_min, live,
                  h, cnt);
    if (live) {
      float r, g, b;  // unused: no radiance
      if (segment<false, true>(scene, pp, h, st, r, g, b, tape + i,
                               stride)) {
        its[i] = st.depth + 1;
        if (steps != nullptr) steps[i] = 0;
        if (kLane > 0) {
          int* out = sweeps + static_cast<size_t>(kLane + 2) * i;
          cnt.store(out);
          out[kLane] = 0;
          out[kLane + 1] = 0;
        }
        live = false;
      }
    }
  }
  __syncwarp();  // the first ray's zeros are written
  if (first >= 0 && lane == 0) {  // the warp's totals
    if (steps != nullptr) steps[first] = nsteps;
    if (kLane > 0) {
      int* out = sweeps + static_cast<size_t>(kLane + 2) * first;
      out[kLane] = cnt.warp_clusters;
      out[kLane + 1] = nsteps;
    }
  }
}

}  // namespace frt
