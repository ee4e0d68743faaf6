// K14 and K15 on Hopper: the tape replay's value and its gradient, the
// device form of diff/replay_pass.py::replay_plain (the op-by-op loop of
// diff/replay.py, ~586 torch ops a tape row, and its autograd), which
// replaces the JAX package's jitted replay (first_raytracer_tpu/diff/
// replay.py:392 `trace_rays_replay`, a lax.scan over the tape with
// jax.checkpoint, differentiated by jax.value_and_grad in diff/grad.py).
//
// K14 (`replay_forward_kernel`): one thread a ray walks the ray's tape
// column from its camera ray.  At each row it gathers the recorded
// primitive's payload row (diff/replay.py::_payload_tables: a sphere's
// centre and radius or a triangle's vertices, then its material's 11
// values), re-solves the hit from it (shade.cuh::recompute), draws the
// bounce's uniforms (mega_common.cuh::draws4 in domain 1 + row, the key
// read from its device tensor on every launch, so a captured graph follows
// the key) and scatters (shade.cuh::scatter), as the plain loop does.  A
// ray adds radiance at most once: at its first miss (no id recorded, or a
// re-hit that fails), throughput x sky, where it stops.  It stops without
// radiance where a metal absorbs it or at the depth cap.  It writes the
// (n, 3) radiance and, when a gradient will be taken, each bounce's (o,
// dr, throughput) into a dense (rows, n, 9) scratch and the row of its
// miss (or -1: no radiance) into `end`.
//
// K15 (`replay_backward_kernel`): the reverse-mode derivative of K14 with
// respect to the payload tables, derived from the port's plain math
// (geometry/sphere.py, geometry/triangle.py, materials/scatter.py,
// core/vecmath.py, render/integrator.py::sky_color) and following
// torch.where's gradient: only the selected branch gets one.  A ray's
// radiance is throughput_k x sky(dr_k) at its miss row k, so its adjoint
// is one sweep back over its own bounces k - 1 .. 0, each re-shaded from
// the saved (o, dr, throughput) bit for bit as K14 shaded it, so every
// branch (the near or far root, the metal's, the dielectric's outside
// flip, total internal reflection and coin, the checker's colour) is the
// forward's.  The attenuation depends on albedo or albedo2 only; the
// checker's sign, the coin, Schlick's weight and the texture point carry
// no gradient; the camera ray is no parameter.  A warp sweeps its rows
// together, from its deepest ray's k down, so that its lanes meet at each
// row: the lanes that add to the same payload row (__match_any_sync on it)
// are summed by their lowest lane, in lane order, and that lane adds the
// sum.  The sums are float64 (diff/replay.py::_Extract's contract: a row
// that a hundred thousand rays read, the final scene's ground, would
// otherwise gather float32 rounding in proportion): into a shared-memory
// copy of both tables when they fit in kSharedTableBytes (the final scene,
// 486 x 15 x 8 B), which each block then adds to the global sum, else
// straight into the global sum (the fields).  A last launch rounds the
// global float64 sum once to the tables' type.  The order of the float64
// additions (the atomics of warps and blocks) changes from run to run:
// the sum moves by a few float64 ulps, so a float32 gradient may differ by
// one float32 ulp between runs of the same inputs, and a float64 one by a
// few ulps of its summands' scale.
//
// Bit-equality.  K14's float32 radiance equals the plain loop's as torch
// runs it on the same device: the same forms as K9 (torch_hits.cuh,
// shade.cuh), the plain loop's gather exact.  The float64 instances
// round as float64 torch does but for the order of torch's own reductions,
// and are held to the plain loop within a relative L2 error of 1e-8.
//
// Bounds on an H100 (utils/roofline.py::k14_bound, k15_bound): K14 reads
// a ray's camera ray, id and tape entries and a payload row and writes its
// scratch row a live bounce; K15 reads them back.  Both are bound by
// bytes at the final scene's few bounces a ray, as K9 is.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"
#include "shade.cuh"
#include "torch_hits.cuh"

namespace {

using frt::root;
using namespace frt::th;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSphereCols = 15;  // centre (3), radius, the material (11)
constexpr int kTriCols = 20;     // v0, v1, v2 (9), the material (11)
constexpr int kSaveCols = 9;     // o, dr, throughput
// The shared-memory copy of the tables' float64 sum, at most: past it K15
// adds straight into the global sum.
constexpr int64_t kSharedTableBytes = 64 * 1024;

template <class T>
struct ReplayArgs {
  const T* sph;  // (ns, kSphereCols)
  const T* tri;  // (nt, kTriCols)
  int64_t ns, nt;
  const T* origin;         // (n, 3)
  const T* direction;      // (n, 3)
  const int64_t* ray_ids;  // (n,)
  const int64_t* key;      // (2,)
  const int* tape;         // rows x stride, ray i's column at i
  int64_t stride;
  int rows, max_depth;
  T t_min;
  int64_t n;
  T* save;   // (rows, n, kSaveCols), or null: no gradient
  int* end;  // (n,), written with save
};

// A tape entry's payload row: its geometry and material, and where it
// lies in the tables' sum (a sphere's index, or ns + a triangle's).
template <class T>
struct Row {
  Geom<T> g;
  Material<T> m;
  int64_t key;
};

// diff/replay.py::_resolve_from_tape's gather: the id clamped into its
// table, spheres first where there are both.
template <class T>
__device__ __forceinline__ Row<T> gather_row(const ReplayArgs<T>& a,
                                             int rec) {
  const int64_t r0 = rec < 0 ? 0 : rec;
  Row<T> w;
  w.g.sphere = a.nt == 0 || (a.ns > 0 && r0 < a.ns);
  const T* row;
  if (w.g.sphere) {
    const int64_t si = r0 > a.ns - 1 ? a.ns - 1 : r0;
    row = a.sph + si * kSphereCols;
    w.g.a = Vec3<T>{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
    w.g.r = __ldg(row + 3);
    w.g.b = w.g.c = Vec3<T>{T(0), T(0), T(0)};
    w.key = si;
    row += 4;
  } else {
    const int64_t q = a.ns == 0 ? r0 : r0 - a.ns;
    const int64_t ti = q > a.nt - 1 ? a.nt - 1 : q;
    row = a.tri + ti * kTriCols;
    w.g.a = Vec3<T>{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
    w.g.b = Vec3<T>{__ldg(row + 3), __ldg(row + 4), __ldg(row + 5)};
    w.g.c = Vec3<T>{__ldg(row + 6), __ldg(row + 7), __ldg(row + 8)};
    w.g.r = T(0);
    w.key = a.ns + ti;
    row += 9;
  }
  // The material block: mtype, fuzz, ref_idx, albedo (3), albedo2 (3),
  // tex_scale, tex_type; the types ride as exact floats.
  w.m.type = static_cast<int>(__ldg(row));
  w.m.fuzz = __ldg(row + 1);
  w.m.ref_idx = __ldg(row + 2);
  w.m.albedo = Vec3<T>{__ldg(row + 3), __ldg(row + 4), __ldg(row + 5)};
  w.m.albedo2 = Vec3<T>{__ldg(row + 6), __ldg(row + 7), __ldg(row + 8)};
  w.m.tex_scale = __ldg(row + 9);
  w.m.tex = static_cast<int>(__ldg(row + 10));
  return w;
}

// One row of a live ray past its recorded id: the hit re-solved from the
// payload row, and where it holds, the bounce's draw and scatter.
template <class T>
struct Bounce {
  Row<T> w;
  Surface<T> h;
  V3 ball;
  Scattered<T> s;
};

// False where the row is a miss: no id, or a re-hit that fails.
template <class T>
__device__ __forceinline__ bool shade_row(const ReplayArgs<T>& a, int rec,
                                          Vec3<T> o, Vec3<T> d, uint32_t k0,
                                          uint32_t k1, uint32_t id, int row,
                                          Bounce<T>& b) {
  if (rec < 0) return false;
  b.w = gather_row(a, rec);
  b.h = recompute(b.w.g, o, d, a.t_min);
  if (!(b.h.t < Lim<T>::big)) return false;
  float u[4];
  frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 1), u);
  b.ball = ball_sample(u);
  b.s = scatter(b.w.m, d, b.h.p, b.h.n, b.ball, u[3]);
  return true;
}

template <class T>
__device__ __forceinline__ T* save_row(const ReplayArgs<T>& a, int row,
                                       int64_t i) {
  return a.save + (static_cast<int64_t>(row) * a.n + i) * kSaveCols;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    replay_forward_kernel(ReplayArgs<T> a, T* radiance) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const uint32_t k0 = static_cast<uint32_t>(__ldg(a.key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(a.key + 1));
  const uint32_t id = static_cast<uint32_t>(__ldg(a.ray_ids + i));
  Vec3<T> o = load3(a.origin, i), d = load3(a.direction, i);
  Vec3<T> tp{T(1), T(1), T(1)}, rad{T(0), T(0), T(0)};
  int end = -1;
  for (int row = 0; row < a.rows; ++row) {
    if (a.save != nullptr) {
      T* s = save_row(a, row, i);
      store3(s, 0, o);
      store3(s, 1, d);
      store3(s, 2, tp);
    }
    const int rec = __ldg(a.tape + row * a.stride + i);
    Bounce<T> b;
    if (!shade_row(a, rec, o, d, k0, k1, id, row, b)) {
      rad = sky(tp, d);
      end = row;
      break;
    }
    if (!b.s.ok || row >= a.max_depth) break;
    tp = mul(tp, b.s.att);
    o = b.h.p;
    d = b.s.dir;
  }
  store3(radiance, i, rad);
  if (a.save != nullptr) a.end[i] = end;
}

// The adjoint of vecmath.normalize(v, eps) at v for the output's adjoint
// g: where(n2 > 0, 1 / sqrt(n2), 0) of the squared length clamped at eps,
// whose gradient passes where it is not below eps.
template <class T>
__device__ __forceinline__ Vec3<T> normalize_adjoint(Vec3<T> v, T eps,
                                                     Vec3<T> g) {
  const T n2 = dot(v, v);
  const bool clamped = eps > T(0) && n2 < eps;
  const T n2c = clamped ? eps : n2;
  if (!(n2c > T(0))) return Vec3<T>{T(0), T(0), T(0)};
  const T inv = T(1) / root(n2c);
  Vec3<T> out = scale(inv, g);
  if (!clamped) out = sub(out, scale(dot(g, v) * inv * inv * inv, v));
  return out;
}

// The adjoint of vecmath.reflect(d, n) = d - 2 (d . n) n for the output's
// adjoint g, added to gd and gn.
template <class T>
__device__ __forceinline__ void reflect_adjoint(Vec3<T> d, Vec3<T> n,
                                                Vec3<T> g, Vec3<T>& gd,
                                                Vec3<T>& gn) {
  const T dn = dot(d, n);
  const T gs = T(-2) * dot(g, n);
  gd = add(gd, add(g, scale(gs, n)));
  gn = add(gn, add(scale(T(-2) * dn, g), scale(gs, d)));
}

// a x b's adjoints: b x g for a, g x a for b.
template <class T>
__device__ __forceinline__ Vec3<T> cross_plain(Vec3<T> a, Vec3<T> b) {
  return Vec3<T>{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                 a.x * b.y - a.y * b.x};
}

// The gradient of one payload row from one bounce, in its columns.
template <class T>
struct RowGrad {
  Vec3<T> a, b, c;  // a sphere's centre; a triangle's v0, v1, v2
  T r, fuzz, ref;
  Vec3<T> albedo, albedo2;
};

// One live bounce backward: the adjoints of its outputs (go of the next
// origin, the hit point; gd of the next direction; gtp of the next
// throughput) to those of its inputs (o, d, tp, in place) and the row's.
template <class T>
__device__ __forceinline__ void bounce_adjoint(const ReplayArgs<T>& a,
                                               const Bounce<T>& b, Vec3<T> o,
                                               Vec3<T> d, Vec3<T> tp,
                                               Vec3<T>& go, Vec3<T>& gd,
                                               Vec3<T>& gtp, RowGrad<T>& gr) {
  const Vec3<T> zero{T(0), T(0), T(0)};
  const T eps = Lim<T>::norm_eps;
  const Vec3<T> p = b.h.p, n = b.h.n;
  const Material<T>& mt = b.w.m;
  gr = RowGrad<T>{zero, zero, zero, T(0), T(0), T(0), zero, zero};
  const Vec3<T> gdir = gd;
  Vec3<T> gp = go, gn = zero;
  Vec3<T> gdi = zero;  // the incoming direction's adjoint
  // tp' = tp * att.
  const Vec3<T> gatt = mul(gtp, tp);
  gtp = mul(gtp, b.s.att);

  // materials/scatter.py, the branch the forward took.
  if (mt.type == kDielectric) {
    const Vec3<T> refl = sub(d, scale(T(2) * dot(d, n), n));
    if (b.s.reflected) {
      reflect_adjoint(d, n, normalize_adjoint(refl, eps, gdir), gdi, gn);
    } else {
      // vecmath.refract(d, on, ni) where it refracts.
      const T ref = mt.ref_idx;
      const bool outside = b.s.outside;
      const Vec3<T> on = outside ? Vec3<T>{-n.x, -n.y, -n.z} : n;
      const T ni = outside ? ref : T(1) / ref;
      const Vec3<T> uv = normalize(d, T(0));
      const T dt = dot(uv, on);
      const T q = T(1) - dt * dt;
      const T sq = root(T(1) - ni * ni * q);
      const Vec3<T> w = sub(uv, scale(dt, on));
      const Vec3<T> refr = sub(scale(ni, w), scale(sq, on));
      const Vec3<T> gr_ = normalize_adjoint(refr, eps, gdir);
      T gni = dot(gr_, w);
      const Vec3<T> gw = scale(ni, gr_);
      const T gsq = -dot(gr_, on);
      Vec3<T> gon = scale(-sq, gr_);
      Vec3<T> guv = gw;
      T gdt = -dot(gw, on);
      gon = sub(gon, scale(dt, gw));
      const T gdisc = gsq * T(0.5) / sq;
      gni = gni - gdisc * T(2) * ni * q;
      gdt = gdt + gdisc * T(2) * ni * ni * dt;
      guv = add(guv, scale(gdt, on));
      gon = add(gon, scale(gdt, uv));
      gdi = add(gdi, normalize_adjoint(d, T(0), guv));
      gn = outside ? sub(gn, gon) : add(gn, gon);
      gr.ref = outside ? gni : -gni / (ref * ref);
    }
  } else {
    if (b.s.alt) {
      gr.albedo2 = gatt;
    } else {
      gr.albedo = gatt;
    }
    const Vec3<T> ball = widen<T>(b.ball);
    if (mt.type == kMetal) {
      const Vec3<T> refl = sub(d, scale(T(2) * dot(d, n), n));
      const Vec3<T> raw = add(refl, scale(mt.fuzz, ball));
      const Vec3<T> graw = normalize_adjoint(raw, eps, gdir);
      gr.fuzz = dot(graw, ball);
      reflect_adjoint(d, n, graw, gdi, gn);
    } else {
      gn = add(gn, normalize_adjoint(add(n, ball), eps, gdir));
    }
  }

  // render/integrator.py::recompute_hit.
  if (b.w.g.sphere) {
    const Vec3<T> c = b.w.g.a;
    const T r = b.w.g.r;
    const Vec3<T> oc = sub(o, c);
    const T bb = dot(oc, d);
    const T sq = root(bb * bb - (dot(oc, oc) - r * r));
    const T tn = -bb - sq;
    const bool near_root = tn > a.t_min && tn < Lim<T>::big;
    // n = (p - c) / r.
    const Vec3<T> pc = sub(p, c);
    const Vec3<T> gpc = Vec3<T>{gn.x / r, gn.y / r, gn.z / r};
    gr.r = -dot(gn, pc) / (r * r);
    gp = add(gp, gpc);
    gr.a = sub(gr.a, gpc);
    // p = o + t d.
    go = gp;
    const T gt = dot(gp, d);
    gdi = add(gdi, scale(b.h.t, gp));
    // t = -b -+ sqrt(b^2 - cc), cc = oc . oc - r^2.
    T gb = -gt;
    const T gdisc = (near_root ? -gt : gt) * T(0.5) / sq;
    gb = gb + T(2) * bb * gdisc;
    const T gcc = -gdisc;
    const Vec3<T> goc = add(scale(T(2) * gcc, oc), scale(gb, d));
    gr.r = gr.r - T(2) * r * gcc;
    gdi = add(gdi, scale(gb, oc));
    go = add(go, goc);
    gr.a = sub(gr.a, goc);
  } else {
    const Vec3<T> v0 = b.w.g.a;
    const Vec3<T> e1 = sub(b.w.g.b, v0), e2 = sub(b.w.g.c, v0);
    // n = normalize(e1 x e2).
    const Vec3<T> gcr = normalize_adjoint(cross(e1, e2), T(0), gn);
    Vec3<T> ge1 = cross_plain(e2, gcr);
    Vec3<T> ge2 = cross_plain(gcr, e1);
    // p = o + t d, t = (e2 . qvec) / det.
    go = gp;
    const T gt = dot(gp, d);
    gdi = add(gdi, scale(b.h.t, gp));
    const Vec3<T> pvec = cross(d, e2);
    const T det = dot(e1, pvec);
    const T inv = T(1) / det;
    const Vec3<T> tvec = sub(o, v0);
    const Vec3<T> qvec = cross(tvec, e1);
    const T tq = dot(e2, qvec);
    const T gtq = gt * inv;
    const T gdet = -(gt * tq) * inv * inv;
    ge1 = add(ge1, scale(gdet, pvec));
    const Vec3<T> gpvec = scale(gdet, e1);
    gdi = add(gdi, cross_plain(e2, gpvec));
    ge2 = add(ge2, cross_plain(gpvec, d));
    ge2 = add(ge2, scale(gtq, qvec));
    const Vec3<T> gq = scale(gtq, e2);
    const Vec3<T> gtvec = cross_plain(e1, gq);
    ge1 = add(ge1, cross_plain(gq, tvec));
    go = add(go, gtvec);
    gr.b = ge1;
    gr.c = ge2;
    gr.a = sub(sub(Vec3<T>{-gtvec.x, -gtvec.y, -gtvec.z}, ge1), ge2);
  }
  gd = gdi;
}

// The value of column `c` of a row's gradient (the material's type,
// texture scale and texture type take none).
template <class T>
__device__ __forceinline__ T grad_col(const RowGrad<T>& g, bool sphere,
                                      int c) {
  const int m = c - (sphere ? 4 : 9);  // the material block's column
  if (sphere) {
    if (c < 3) return c == 0 ? g.a.x : (c == 1 ? g.a.y : g.a.z);
    if (c == 3) return g.r;
  } else if (c < 9) {
    const Vec3<T> v = c < 3 ? g.a : (c < 6 ? g.b : g.c);
    const int k = c % 3;
    return k == 0 ? v.x : (k == 1 ? v.y : v.z);
  }
  switch (m) {
    case 1: return g.fuzz;
    case 2: return g.ref;
    case 3: return g.albedo.x;
    case 4: return g.albedo.y;
    case 5: return g.albedo.z;
    case 6: return g.albedo2.x;
    case 7: return g.albedo2.y;
    case 8: return g.albedo2.z;
    default: return T(0);
  }
}

// The sum's offset of a row, and its columns.
__device__ __forceinline__ int64_t row_offset(int64_t key, int64_t ns) {
  return key < ns ? key * kSphereCols : ns * kSphereCols +
                                            (key - ns) * kTriCols;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    replay_backward_kernel(ReplayArgs<T> a, const T* grad, double* sum,
                           int shared_table) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* stage = smem + warp * 32;
  const int64_t cols = a.ns * kSphereCols + a.nt * kTriCols;
  double* table = shared_table ? smem + kThreads : sum;
  if (shared_table) {
    for (int64_t j = threadIdx.x; j < cols; j += kThreads) table[j] = 0.0;
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int k = i < a.n ? a.end[i] : -1;
  int deepest = k;
  for (int off = 16; off > 0; off >>= 1)
    deepest = max(deepest, __shfl_xor_sync(kFullMask, deepest, off));

  // The miss row: radiance = tp * sky(dr), sky's colour linear in dr.y
  // with slope (blue - white) / 2.
  Vec3<T> go{T(0), T(0), T(0)}, gd = go, gtp = go;
  uint32_t k0 = 0, k1 = 0, id = 0;
  if (k >= 0) {
    k0 = static_cast<uint32_t>(__ldg(a.key));
    k1 = static_cast<uint32_t>(__ldg(a.key + 1));
    id = static_cast<uint32_t>(__ldg(a.ray_ids + i));
    const T* s = save_row(a, k, i);
    const Vec3<T> dk = state3(s, 1), tpk = state3(s, 2);
    const Vec3<T> g = load3(grad, i);
    gtp = mul(g, sky_color(dk));
    const T half = T(0.5);
    gd.y = g.x * tpk.x * (half * (T(0.5f) - T(1))) +
           g.y * tpk.y * (half * (T(0.7f) - T(1))) +
           g.z * tpk.z * (half * (T(1.0f) - T(1)));
  }

  for (int row = deepest - 1; row >= 0; --row) {
    const bool on = row < k;
    RowGrad<T> gr;
    int64_t key = -1;
    bool sphere = true;
    if (on) {
      const T* s = save_row(a, row, i);
      const Vec3<T> o = state3(s, 0), d = state3(s, 1), tp = state3(s, 2);
      const int rec = __ldg(a.tape + row * a.stride + i);
      Bounce<T> b;
      shade_row(a, rec, o, d, k0, k1, id, row, b);
      bounce_adjoint(a, b, o, d, tp, go, gd, gtp, gr);
      key = b.w.key;
      sphere = b.w.g.sphere;
    }
    // The lanes of this row's payload row, summed by the lowest of them in
    // lane order, a column at a time through the warp's stage.
    const unsigned peers = __match_any_sync(kFullMask, key);
    const bool lead = on && lane == __ffs(static_cast<int>(peers)) - 1;
    double* dst = table + (on ? row_offset(key, a.ns) : 0);
    const int ncols = sphere ? kSphereCols : kTriCols;
#pragma unroll
    for (int c = 0; c < kTriCols; ++c) {
      stage[lane] = on && c < ncols ? static_cast<double>(
                                          grad_col(gr, sphere, c))
                                    : 0.0;
      __syncwarp();
      if (lead && c < ncols) {
        double total = 0.0;
        for (unsigned m = peers; m != 0; m &= m - 1)
          total += stage[__ffs(static_cast<int>(m)) - 1];
        if (total != 0.0) atomicAdd(dst + c, total);
      }
      __syncwarp();
    }
  }

  if (shared_table) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < cols; j += kThreads) {
      const double v = table[j];
      if (v != 0.0) atomicAdd(sum + j, v);
    }
  }
}

// The float64 sums rounded once to the tables' type.
template <class T>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const double* sum, int64_t sph_cols, int64_t cols,
                 T* grad_sph, T* grad_tri) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < sph_cols) {
    grad_sph[j] = static_cast<T>(sum[j]);
  } else if (j < cols) {
    grad_tri[j - sph_cols] = static_cast<T>(sum[j]);
  }
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <class T>
ReplayArgs<T> replay_args(const T* sph, int64_t ns, const T* tri, int64_t nt,
                          const T* origin, const T* direction,
                          const int64_t* ray_ids, const int64_t* key,
                          const int* tape, int64_t stride, int rows,
                          int max_depth, double t_min, int64_t n, T* save,
                          int* end) {
  return ReplayArgs<T>{sph,       tri,     ns,  nt,   origin,
                       direction, ray_ids, key, tape, stride,
                       rows,      max_depth, static_cast<T>(t_min),
                       n,         save,    end};
}

template <class T>
int forward(const T* sph, int64_t ns, const T* tri, int64_t nt,
            const T* origin, const T* direction, const int64_t* ray_ids,
            const int64_t* key, const int* tape, int64_t stride, int rows,
            int max_depth, double t_min, int64_t n, T* radiance, T* save,
            int* end, void* stream) {
  if (n > 0) {
    const ReplayArgs<T> a =
        replay_args(sph, ns, tri, nt, origin, direction, ray_ids, key, tape,
                    stride, rows, max_depth, t_min, n, save, end);
    replay_forward_kernel<T><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a,
                                                                    radiance);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int backward(const T* sph, int64_t ns, const T* tri, int64_t nt,
             const int64_t* ray_ids, const int64_t* key, const int* tape,
             int64_t stride, int rows, int max_depth, double t_min,
             int64_t n, const T* save, const int* end, const T* grad,
             double* sum, T* grad_sph, T* grad_tri, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t sph_cols = ns * kSphereCols, cols = sph_cols + nt * kTriCols;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && cols > 0)
    err = cudaMemsetAsync(sum, 0, cols * sizeof(double), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && cols > 0) {
    const ReplayArgs<T> a = replay_args(
        sph, ns, tri, nt, static_cast<const T*>(nullptr),
        static_cast<const T*>(nullptr), ray_ids, key, tape, stride, rows,
        max_depth, t_min, n, const_cast<T*>(save), const_cast<int*>(end));
    const bool shared = cols * static_cast<int64_t>(sizeof(double)) <=
                        kSharedTableBytes;
    const int bytes = static_cast<int>(
        (kThreads + (shared ? cols : 0)) * sizeof(double));
    err = cudaFuncSetAttribute(replay_backward_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    replay_backward_kernel<T><<<blocks_for(n), kThreads, bytes, s>>>(
        a, grad, sum, shared ? 1 : 0);
  }
  if (cols > 0)
    round_kernel<T><<<blocks_for(cols), kThreads, 0, s>>>(sum, sph_cols, cols,
                                                          grad_sph, grad_tri);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K14 on `stream` over n rays (module comment): the payload
// tables (ns, 15) and (nt, 20), the camera rays origin, direction (n, 3),
// the ray ids (n,) int64, the key (2,) int64 on the device, the tape (rows
// of int32, row r of ray i at tape[r * stride + i]), the depth cap, t_min,
// and the outputs: the radiance (n, 3) and, where save is not null, the
// scratch (rows, n, 9) and end (n,) int32 that K15 reads.  Launches
// nothing for n = 0.
int frt_replay_forward_f32(const float* sph, int64_t ns, const float* tri,
                           int64_t nt, const float* origin,
                           const float* direction, const int64_t* ray_ids,
                           const int64_t* key, const int* tape,
                           int64_t stride, int rows, int max_depth,
                           double t_min, int64_t n, float* radiance,
                           float* save, int* end, void* stream) {
  return forward<float>(sph, ns, tri, nt, origin, direction, ray_ids, key,
                        tape, stride, rows, max_depth, t_min, n, radiance,
                        save, end, stream);
}

int frt_replay_forward_f64(const double* sph, int64_t ns, const double* tri,
                           int64_t nt, const double* origin,
                           const double* direction, const int64_t* ray_ids,
                           const int64_t* key, const int* tape,
                           int64_t stride, int rows, int max_depth,
                           double t_min, int64_t n, double* radiance,
                           double* save, int* end, void* stream) {
  return forward<double>(sph, ns, tri, nt, origin, direction, ray_ids, key,
                         tape, stride, rows, max_depth, t_min, n, radiance,
                         save, end, stream);
}

// Launches K15 on `stream` (module comment): the forward's tables, ids,
// key, tape and scalars, its scratch and end, the radiance's adjoint grad
// (n, 3); zeroes the float64 sum (ns * 15 + nt * 20), adds into it and
// rounds it into grad_sph (ns, 15) and grad_tri (nt, 20).
int frt_replay_backward_f32(const float* sph, int64_t ns, const float* tri,
                            int64_t nt, const int64_t* ray_ids,
                            const int64_t* key, const int* tape,
                            int64_t stride, int rows, int max_depth,
                            double t_min, int64_t n, const float* save,
                            const int* end, const float* grad, double* sum,
                            float* grad_sph, float* grad_tri, void* stream) {
  return backward<float>(sph, ns, tri, nt, ray_ids, key, tape, stride, rows,
                         max_depth, t_min, n, save, end, grad, sum, grad_sph,
                         grad_tri, stream);
}

int frt_replay_backward_f64(const double* sph, int64_t ns, const double* tri,
                            int64_t nt, const int64_t* ray_ids,
                            const int64_t* key, const int* tape,
                            int64_t stride, int rows, int max_depth,
                            double t_min, int64_t n, const double* save,
                            const int* end, const double* grad, double* sum,
                            double* grad_sph, double* grad_tri,
                            void* stream) {
  return backward<double>(sph, ns, tri, nt, ray_ids, key, tape, stride, rows,
                          max_depth, t_min, n, save, end, grad, sum,
                          grad_sph, grad_tri, stream);
}

}  // extern "C"
