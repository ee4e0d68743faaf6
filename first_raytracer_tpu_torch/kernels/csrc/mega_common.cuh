// Device code shared by the megakernel (K1, and K2 = K1 with a tape), the
// standalone tape recorder (K2b) and the clustered megakernel (K3, K3t): the
// Threefry stream, the thin-lens camera ray, the dense sweep with exact
// closest-hit selection, the shading, and one routine that traces a path to
// termination.  Every kernel traces through
// `trace_path`, templated over the scene's closest-hit routine (DenseScene
// here, ClusterScene in megakernel_clustered.cu), so the recorded tapes
// cannot drift from the rendered paths and a clustered path is shaded by the
// same code as a dense one.
//
// Dense scene tables (built on the host by
// kernels/megakernel.py::pack_scene_mega, primitives sorted into six
// (material, texture) groups):
//   sph (16, ns_pad) plane-major: 0-2 center, 3 radius, 4 param (fuzz |
//       ref_idx), 5-7 albedo, 8-10 albedo2, 11 tex_scale, 12 c0, 13 original
//       id, 15 1/radius;
//   mx  (ns_pad, 8): cx cy cz c0 pad, c0 = |C|^2 - r^2 rounded from f64;
//   tri (24, nt_pad) plane-major: 0-2 v0, 3-5 e1, 6-8 e2, 9-11 unit normal,
//       12 param, 13-15 albedo, 16-18 albedo2, 19 tex_scale, 20 original id.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace frt {

constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.283185307179586f;

struct Tables {
  const float* cam;   // (20,): origin, lower_left, horizontal, vertical,
                      // lens u, lens v, lens radius, pad
  const float* sph;   // (16, ns_pad)
  const float4* mx;   // (ns_pad, 2) float4 = (ns_pad, 8) floats
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

// The dense scene of K1, K2 and K2b.
struct DenseScene {
  Tables tb;
  struct Counters {};  // the dense sweep counts nothing

  // Dense sweep of every sphere and triangle with exact (min t, lowest
  // sorted index) selection; a sphere wins a sphere/triangle tie.  The
  // clustered sweep (megakernel_clustered.cu) repeats these hit tests as
  // functions; here they stay spelled out in the loops, where ptxas turns
  // the miss into a skip: written with the functions, it merged the miss
  // into the compare, two more instructions per sphere, and K1 took
  // 35.5-36.0 ms against 32.4-33.1 (H100, PERF.md).
  __device__ __forceinline__ void closest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, Hit& h,
                                          Counters&) const {
    const float4* __restrict__ mx = tb.mx;
    const float* __restrict__ tri = tb.tri;
    const int tp = tb.nt_pad;
    // Expanded quadratic: b = o.d - d.C, c = |o|^2 - 2 o.C + c0.
    const float od = ox * dx + oy * dy + oz * dz;
    const float oo = ox * ox + oy * oy + oz * oz;
    float t_s = kBig;
    int w_s = 0;
    for (int i = 0; i < tb.ns; ++i) {
      const float4 c = __ldg(&mx[2 * i]);
      const float dc = c.x * dx + c.y * dy + c.z * dz;
      const float oc = c.x * ox + c.y * oy + c.z * oz;
      const float bq = od - dc;
      const float cq = oo - 2.0f * oc + c.w;
      const float disc = bq * bq - cq;
      if (!(disc >= 0.0f)) continue;  // no root (or NaN): a miss
      const float sq = sqrtf(disc);
      const float tn = -bq - sq;
      const float tf = sq - bq;
      const float t = tn > t_min ? tn : (tf > t_min ? tf : kBig);
      if (t < t_s) {  // strict: the lowest index wins a tie
        t_s = t;
        w_s = i;
      }
    }
    // Moller-Trumbore on prepacked edges.
    float t_t = kBig;
    int w_t = 0;
    for (int i = 0; i < tb.nt; ++i) {
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
      if (!(fabsf(det) > 1e-9f)) continue;
      const float inv = 1.0f / det;
      const float tvx = ox - __ldg(&tri[0 * tp + i]);
      const float tvy = oy - __ldg(&tri[1 * tp + i]);
      const float tvz = oz - __ldg(&tri[2 * tp + i]);
      const float uu = (tvx * px + tvy * py + tvz * pz) * inv;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float vv = (dx * qx + dy * qy + dz * qz) * inv;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
      if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && t > t_min &&
          t < kBig && t < t_t) {
        t_t = t;
        w_t = i;
      }
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

// Traces ray `rid` of the pixel at column `fi`, bottom-up row `fj`, to
// termination through `scene`'s closest-hit routine and returns its segment
// count.  With kRadiance the path's radiance is added to `sum`; with kTape
// row d of the path's tape column (`tape[d * stride]`) gets the original
// scene id of the primitive hit at bounce d, or -1 on a miss or after the
// path ended, for every d up to max_depth.  `cnt` collects what the scene's
// sweep counts.
template <bool kRadiance, bool kTape, class Scene>
__device__ __forceinline__ int trace_path(const Scene& scene,
                                          typename Scene::Counters& cnt,
                                          const CameraRow& cam,
                                          const PathParams& pp, uint32_t rid,
                                          float fi, float fj, float& sum_r,
                                          float& sum_g, float& sum_b,
                                          int* __restrict__ tape,
                                          size_t stride) {
  const float t_min = pp.t_min;
  float u[4];
  draws4(pp.k0, pp.k1, rid, 0u, u);  // camera domain
  float ox, oy, oz, dx, dy, dz;
  camera_ray(cam, fi, fj, pp.nx, pp.ny, u, ox, oy, oz, dx, dy, dz);
  float tp_r = 1.0f, tp_g = 1.0f, tp_b = 1.0f;

  int depth = 0;
  for (;; ++depth) {
    Hit h;
    scene.closest(ox, oy, oz, dx, dy, dz, t_min, h, cnt);
    const float t_best = h.t;
    if (!(t_best < kBig)) {  // miss: sky, white -> blue by height
      if (kRadiance) {
        const float skyt = 0.5f * (dy + 1.0f);
        sum_r += tp_r * ((1.0f - skyt) + skyt * 0.5f);
        sum_g += tp_g * ((1.0f - skyt) + skyt * 0.7f);
        sum_b += tp_b * ((1.0f - skyt) + skyt * 1.0f);
      }
      if (kTape) tape[depth * stride] = -1;
      break;
    }
    if (kTape) tape[depth * stride] = scene.original_id(h);

    // Hit record and the winner's material, read from its payload row.
    const float hx = ox + t_best * dx;
    const float hy = oy + t_best * dy;
    const float hz = oz + t_best * dz;
    Surface f;
    scene.surface(h, hx, hy, hz, f);
    const float nx = f.nx, ny = f.ny, nz = f.nz, param = f.param;
    const float a0r = f.a0r, a0g = f.a0g, a0b = f.a0b;
    const float a1r = f.a1r, a1g = f.a1g, a1b = f.a1b, tsc = f.tsc;
    const bool metal = f.metal, diel = f.diel, check = f.check;

    // Bounce-domain draws: unit-ball sample and the dielectric coin.
    draws4(pp.k0, pp.k1, rid, static_cast<uint32_t>(depth + 1), u);
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
    if (diel) {
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
      if (metal) {
        ndx = refx + param * bx;
        ndy = refy + param * by;
        ndz = refz + param * bzz;
        scattered = (ndx * nx + ndy * ny + ndz * nz) > 0.0f;
      } else {
        ndx = nx + bx;
        ndy = ny + by;
        ndz = nz + bzz;
      }
      normalize3(ndx, ndy, ndz, 1e-20f);
      if (kRadiance) {
        bool odd = false;
        if (check) {
          odd = sinf(tsc * hx) * sinf(tsc * hy) * sinf(tsc * hz) < 0.0f;
        }
        att_r = odd ? a1r : a0r;
        att_g = odd ? a1g : a0g;
        att_b = odd ? a1b : a0b;
      }
    }
    // Absorbed (metal below the surface) or at the depth cap: black.
    if (!scattered || depth >= pp.max_depth) break;
    tp_r *= att_r;
    tp_g *= att_g;
    tp_b *= att_b;
    ox = hx;
    oy = hy;
    oz = hz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }
  if (kTape) {
    for (int d = depth + 1; d <= pp.max_depth; ++d) tape[d * stride] = -1;
  }
  return depth + 1;
}

}  // namespace frt
