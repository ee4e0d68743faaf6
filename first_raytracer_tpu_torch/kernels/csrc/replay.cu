// K14 and K15 on Hopper: the tape replay's value and its gradient, the
// device form of diff/replay_pass.py::replay_plain (the op-by-op loop of
// diff/replay.py, ~586 torch ops a tape row, and its autograd), which
// replaces the JAX package's jitted replay (first_raytracer_tpu/diff/
// replay.py:392 `trace_rays_replay`, a lax.scan over the tape with
// jax.checkpoint, differentiated by jax.value_and_grad in diff/grad.py).
//
// K14 (`replay_forward_kernel`): a lane walks a ray's tape column from its
// camera ray.  At each row it gathers the recorded primitive's payload row
// (diff/replay.py::_payload_tables: a sphere's centre and radius or a
// triangle's vertices, then its material's 11 values), re-solves the hit
// from it (shade.cuh::recompute), draws the bounce's uniforms
// (mega_common.cuh::draws4 in domain 1 + row, the key read from its device
// tensor on every launch, so a captured graph follows the key) and
// scatters (shade.cuh::scatter), as the plain loop does.  A ray adds
// radiance at most once: at its first miss (no id recorded, or a re-hit
// that fails), throughput x sky, where it stops.  It stops without
// radiance where a metal absorbs it or at the depth cap.  It writes the
// (n, 3) radiance and, when a gradient will be taken, each bounce's (o,
// dr, throughput) into a dense (rows, n, 9) scratch, the row of its miss
// (or -1: no radiance) into `end`, and counts the rays by miss row into a
// histogram of `rows` bins (a warp's lanes on one row matched by
// __match_any_sync, one add each).  Row r + 1's payload row and row r + 2's
// tape entry are issued before row r's recompute and scatter, so the chain
// waits on no load; the draw stays in the row (issued a row ahead it is
// work thrown away for most rays, which end at row 1 or 2, and it measured
// no faster).  The launch is bound by the instructions its warps issue
// over their rows (a warp runs until its deepest lane's ray ends, so at
// the final scene's skewed depths most of its lanes idle) and by its
// deepest ray's chain of rows; a persistent grid whose lanes took the next
// ray as theirs ended waited on each new ray's loads and was slower
// (PERF.md section 5).
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
// no gradient; the camera ray is no parameter.
//
// The sweep's order.  `replay_order_kernel` sorts the rays with a miss
// (end >= 0) by it, deepest first: a counting sort over K14's histogram
// (each block sums the bins deeper than each row and takes one run a row
// after that row's cursor).  K15 is a persistent grid of the blocks the
// card holds at once; each warp takes the next work of the order by an
// atomic ticket, so the deepest rays start at once and the shallow ones
// fill in behind them.  A ray of kDeepRows rows or more takes a warp of its
// own: its rows' re-shades do not depend on the adjoint, so lane l
// re-shades row top - 1 - l of 32 at a time, and every lane then carries
// the adjoint down those rows (each row's bounce shuffled from its lane),
// so that the chain holds only the adjoint's arithmetic.  The other rays go
// 32 to a warp, their lanes within a row or two of each other in depth,
// and sweep their rows together from the warp's deepest miss down, so that
// the lanes meet at each row; each row's saved state, tape entry, payload
// row and draw for the row below are issued before the row's re-shade and
// adjoint.  The ticket and the cursors live beside the float64 sum, zeroed
// with it by the launch's memset, so a captured graph replays them from
// zero and the bucketed step's launches never read each other's.
//
// The sum.  The lanes that add to one payload row (__match_any_sync on it)
// are summed in log2 steps of shuffles, rank r taking rank r + 2^j's
// partial, all of a row's 18 gradient values at once, and the lowest adds
// the totals.  The totals are float64 (diff/replay.py::_Extract's
// contract: a row that a hundred thousand rays read, the final scene's
// ground, would otherwise gather float32 rounding in proportion): where
// kHotPeers lanes or more met on the row (the ground) into one of the
// warp's kHotRows shared rows (claimed by atomicCAS on its tag, then plain
// adds: only that lane of that warp writes it), added to the global sum
// when the warp ends; else straight into the global sum.  A last launch
// rounds the global float64 sum once to the tables' type.  The order of
// the float64 additions (the tree, the atomics of warps) changes from run
// to run: the sum moves by a few float64 ulps, so a float32 gradient may
// differ by one float32 ulp between runs of the same inputs, and a float64
// one by a few ulps of its summands' scale.
//
// Bit-equality.  K14's float32 radiance equals the plain loop's as torch
// runs it on the same device: the same forms as K9 (torch_hits.cuh,
// shade.cuh), the plain loop's gather exact, each ray's arithmetic and
// its order the same whichever lane or warp runs it.  The float64 instances
// round as float64 torch does but for the order of torch's own reductions,
// and are held to the plain loop within a relative L2 error of 1e-8.
//
// Bounds on an H100 (utils/roofline.py::k14_bound, k15_bound): K14 reads
// a ray's camera ray, id and tape entries and a payload row and writes its
// scratch row a live bounce; K15 reads them back.  Both are bound by
// bytes at the final scene's few bounces a ray, and both wait on their
// deepest ray's chain of rows.
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
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSphereCols = 15;  // centre (3), radius, the material (11)
constexpr int kTriCols = 20;     // v0, v1, v2 (9), the material (11)
constexpr int kSaveCols = 9;     // o, dr, throughput
constexpr int kWarps = kThreads / 32;
// K15: a warp's shared rows of the float64 sum, the lanes of one row that
// claim one, a row's gradient values (RowGrad's fields), and the rows to
// sweep from which a ray takes a warp of its own.
constexpr int kHotRows = 4;
constexpr int kHotPeers = 4;
constexpr int kFields = 18;
constexpr int kDeepRows = 12;
// Rays a thread of the order's launch.
constexpr int kOrderRays = 4;
constexpr unsigned long long kNoRow = ~0ull;

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

// Ray i's tape entry at `row`, -1 past the tape.
template <class T>
__device__ __forceinline__ int tape_at(const ReplayArgs<T>& a, int row,
                                       int64_t i) {
  return row < a.rows ? __ldg(a.tape + static_cast<int64_t>(row) * a.stride +
                              i)
                      : -1;
}

// What a row needs that does not depend on the row before it: the tape
// entry, its payload row and the bounce's draw (the ball and the coin),
// issued a row ahead of the chain.
template <class T>
struct Ahead {
  int rec;
  Row<T> w;
  V3 ball;
  float coin;
};

template <class T>
__device__ __forceinline__ Ahead<T> ahead(const ReplayArgs<T>& a, int rec,
                                          uint32_t k0, uint32_t k1,
                                          uint32_t id, int row) {
  Ahead<T> x;
  x.rec = rec;
  x.w = gather_row(a, rec);
  float u[4];
  frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 1), u);
  x.ball = ball_sample(u);
  x.coin = u[3];
  return x;
}

// One row of a live ray past its recorded id: the hit re-solved from the
// payload row, and where it holds, the bounce's scatter.
template <class T>
struct Bounce {
  Row<T> w;
  Surface<T> h;
  V3 ball;
  Scattered<T> s;
};

// False where the row is a miss: no id, or a re-hit that fails.
template <class T>
__device__ __forceinline__ bool shade_row(const ReplayArgs<T>& a,
                                          const Ahead<T>& x, Vec3<T> o,
                                          Vec3<T> d, Bounce<T>& b) {
  if (x.rec < 0) return false;
  b.w = x.w;
  b.h = recompute(b.w.g, o, d, a.t_min);
  if (!(b.h.t < Lim<T>::big)) return false;
  b.ball = x.ball;
  b.s = scatter(b.w.m, d, b.h.p, b.h.n, b.ball, x.coin);
  return true;
}

template <class T>
__device__ __forceinline__ T* save_row(const ReplayArgs<T>& a, int row,
                                       int64_t i) {
  return a.save + (static_cast<int64_t>(row) * a.n + i) * kSaveCols;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    replay_forward_kernel(ReplayArgs<T> a, T* radiance, int* hist) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int end = -1;
  if (i < a.n) {
    const uint32_t k0 = static_cast<uint32_t>(__ldg(a.key));
    const uint32_t k1 = static_cast<uint32_t>(__ldg(a.key + 1));
    const uint32_t id = static_cast<uint32_t>(__ldg(a.ray_ids + i));
    Vec3<T> o = load3(a.origin, i), d = load3(a.direction, i);
    Vec3<T> tp{T(1), T(1), T(1)}, rad{T(0), T(0), T(0)};
    // The row's tape entry and payload row, the next row's tape entry.
    int rec = tape_at(a, 0, i), rec_next = tape_at(a, 1, i);
    Row<T> w = gather_row(a, rec);
    for (int row = 0; row < a.rows; ++row) {
      if (a.save != nullptr) {
        T* s = save_row(a, row, i);
        store3(s, 0, o);
        store3(s, 1, d);
        store3(s, 2, tp);
      }
      // Row + 1's payload row and row + 2's tape entry, ahead of this row's
      // chain.
      const int rec_after = tape_at(a, row + 2, i);
      const Row<T> w_next = gather_row(a, rec_next);
      Ahead<T> x;
      x.rec = rec;
      x.w = w;
      float u[4];
      frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 1), u);
      x.ball = ball_sample(u);
      x.coin = u[3];
      Bounce<T> b;
      if (!shade_row(a, x, o, d, b)) {
        rad = sky(tp, d);
        end = row;
        break;
      }
      if (!b.s.ok || row >= a.max_depth) break;
      tp = mul(tp, b.s.att);
      o = b.h.p;
      d = b.s.dir;
      rec = rec_next;
      rec_next = rec_after;
      w = w_next;
    }
    store3(radiance, i, rad);
    if (a.save != nullptr) a.end[i] = end;
  }
  if (hist != nullptr) {
    // The rays by miss row: the lowest lane of each row's lanes adds them.
    const unsigned peers = __match_any_sync(kFullMask, end);
    const int lane = threadIdx.x & 31;
    if (end >= 0 && lane == __ffs(static_cast<int>(peers)) - 1)
      atomicAdd(hist + end, __popc(peers));
  }
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

// The sum's offset of a row.
__device__ __forceinline__ int64_t row_offset(int64_t key, int64_t ns) {
  return key < ns ? key * kSphereCols : ns * kSphereCols +
                                            (key - ns) * kTriCols;
}

// A row's gradient as kFields float64 values: a (3), b (3), c (3), r,
// fuzz, ref_idx, albedo (3), albedo2 (3).
template <class T>
__device__ __forceinline__ void row_fields(const RowGrad<T>& g,
                                           double (&f)[kFields]) {
  const T v[kFields] = {g.a.x,      g.a.y,      g.a.z,      g.b.x,
                        g.b.y,      g.b.z,      g.c.x,      g.c.y,
                        g.c.z,      g.r,        g.fuzz,     g.ref,
                        g.albedo.x, g.albedo.y, g.albedo.z, g.albedo2.x,
                        g.albedo2.y, g.albedo2.z};
#pragma unroll
  for (int q = 0; q < kFields; ++q) f[q] = static_cast<double>(v[q]);
}

// The column of field q in a sphere's row or a triangle's, -1 where that
// table has none (a sphere's b and c, a triangle's r); the material's
// type, texture scale and texture type take no gradient.
__device__ __forceinline__ int field_col(int q, bool sphere) {
  if (q < 3) return q;
  if (q < 9) return sphere ? -1 : q;
  if (q == 9) return sphere ? 3 : -1;
  return (sphere ? kSphereCols - 11 : kTriCols - 11) + q - 9;
}

// The lane of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_lane(unsigned m, int k) {
  int lane = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (k >= c) {
      k -= c;
      m >>= w;
      lane += w;
    } else {
      m = low;
    }
  }
  return lane;
}

// K15's shared memory: each warp's shared rows of the float64 sum (a
// row's tag, its key or kNoRow, and its fields), and the order's rays and
// deep rays (K14's histogram summed).
struct Shared {
  unsigned long long tag[kWarps][kHotRows];
  double sum[kWarps][kHotRows][kFields];
  int rays, deep;
};

// A shared row of warp w for `key`, found or claimed, or null: the warp's
// rows are taken.
__device__ __forceinline__ double* hot_row(Shared& sh, int w, int64_t key) {
  const unsigned long long tag = static_cast<unsigned long long>(key);
#pragma unroll
  for (int s = 0; s < kHotRows; ++s) {
    unsigned long long was =
        *static_cast<volatile unsigned long long*>(&sh.tag[w][s]);
    if (was == kNoRow) was = atomicCAS(&sh.tag[w][s], kNoRow, tag);
    if (was == kNoRow || was == tag) return sh.sum[w][s];
  }
  return nullptr;
}

// One row's gradients summed over the warp's lanes (a collective of the
// whole warp): `key` is the lane's payload row, -1 where it adds nothing.
// The lanes of one row are summed in log2 steps of shuffles (rank r takes
// rank r + 2^j's partial when r is a multiple of 2^(j+1)), all fields at
// once; rank 0 adds the totals: into a shared row of its warp where
// kHotPeers lanes or more met on the row (the ground), else into the
// global sum.
template <class T>
__device__ __forceinline__ void add_row(Shared& sh, int w, double* sum,
                                        int64_t ns, int64_t key, bool sphere,
                                        const RowGrad<T>& gr, int lane) {
  const bool on = key >= 0;
  const unsigned peers = __match_any_sync(kFullMask, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int size = __popc(peers);
  const bool tri = __any_sync(kFullMask, on && !sphere);
  const bool sph = __any_sync(kFullMask, on && sphere);
  double f[kFields];
  row_fields(gr, f);
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (!__any_sync(kFullMask, on && size > (1 << j))) break;
    const bool take =
        on && (rank & ((2 << j) - 1)) == 0 && rank + (1 << j) < size;
    const int src = take ? nth_lane(peers, rank + (1 << j)) : lane;
#pragma unroll
    for (int q = 0; q < kFields; ++q) {
      if ((q >= 3 && q < 9 && !tri) || (q == 9 && !sph)) continue;
      const double v = __shfl_sync(kFullMask, f[q], src);
      if (take) f[q] += v;
    }
  }
  if (!on || rank != 0) return;
  double* hot = size >= kHotPeers ? hot_row(sh, w, key) : nullptr;
  double* row = sum + row_offset(key, ns);
#pragma unroll
  for (int q = 0; q < kFields; ++q) {
    const int c = field_col(q, sphere);
    if (c < 0 || f[q] == 0.0) continue;
    if (hot != nullptr) {
      hot[q] += f[q];
    } else {
      atomicAdd(row + c, f[q]);
    }
  }
}

// Warp w's shared rows added into the global sum.
__device__ __forceinline__ void flush_rows(Shared& sh, int w, double* sum,
                                           int64_t ns, int lane) {
  __syncwarp();
  for (int e = lane; e < kHotRows * kFields; e += 32) {
    const unsigned long long tag = sh.tag[w][e / kFields];
    const int q = e % kFields;
    if (tag == kNoRow) continue;
    const int64_t key = static_cast<int64_t>(tag);
    const int c = field_col(q, key < ns);
    const double v = sh.sum[w][e / kFields][q];
    if (c >= 0 && v != 0.0) atomicAdd(sum + row_offset(key, ns) + c, v);
  }
}

// The order of the rays with a miss row (end >= 0), deepest first: each
// block, kOrderRays rays a thread, sums K14's bins deeper than each row,
// counts its own rays by row in shared memory (a warp's lanes on one row
// with one add; a ray's count before it is its place in the block's run),
// and takes one run a row after that row's cursor with one atomic.  Few
// blocks, so that few atomics queue on the cursors of the crowded rows.
__global__ void __launch_bounds__(kThreads)
    replay_order_kernel(const int* end, const int* hist, int rows, int64_t n,
                        int* cursor, int* order) {
  extern __shared__ int runs[];  // (3, rows): deeper, the block's, its base
  int* deeper = runs;
  int* count = runs + rows;
  int* base = runs + 2 * rows;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    int s = 0;
    for (int e = r + 1; e < rows; ++e) s += __ldg(hist + e);
    deeper[r] = s;
    count[r] = 0;
  }
  const int lane = threadIdx.x & 31;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kOrderRays * kThreads + threadIdx.x;
  int e[kOrderRays], rank[kOrderRays];
#pragma unroll
  for (int j = 0; j < kOrderRays; ++j) {
    const int64_t i = first + j * kThreads;
    e[j] = i < n ? __ldg(end + i) : -1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kOrderRays; ++j) {
    const unsigned peers = __match_any_sync(kFullMask, e[j]);
    const int leader = __ffs(static_cast<int>(peers)) - 1;
    int at = 0;
    if (e[j] >= 0 && lane == leader)
      at = atomicAdd(count + e[j], __popc(peers));
    rank[j] = __shfl_sync(kFullMask, at, leader) +
              __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads)
    base[r] = count[r] > 0 ? atomicAdd(cursor + r, count[r]) : 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kOrderRays; ++j)
    if (e[j] >= 0)
      order[deeper[e[j]] + base[e[j]] + rank[j]] =
          static_cast<int>(first + j * kThreads);
}

// The seed of ray i's adjoint at its miss row k: radiance = tp * sky(dr),
// sky's colour linear in dr.y with slope (blue - white) / 2.
template <class T>
__device__ __forceinline__ void seed(const ReplayArgs<T>& a, const T* grad,
                                     int64_t i, int k, Vec3<T>& gd,
                                     Vec3<T>& gtp) {
  const T* s = save_row(a, k, i);
  const Vec3<T> dk = load3(s, 1), tpk = load3(s, 2);
  const Vec3<T> g = load3(grad, i);
  gtp = mul(g, sky_color(dk));
  const T half = T(0.5);
  gd.y = g.x * tpk.x * (half * (T(0.5f) - T(1))) +
         g.y * tpk.y * (half * (T(0.7f) - T(1))) +
         g.z * tpk.z * (half * (T(1.0f) - T(1)));
}

// One warp's sweep back over the rays of its 32 places of the order (ray
// i, or -1 past the order's end), all lanes at one row.
template <class T>
__device__ __forceinline__ void sweep(const ReplayArgs<T>& a, const T* grad,
                                      Shared& sh, int w, double* sum,
                                      int64_t i, int lane) {
  const int k = i >= 0 ? __ldg(a.end + i) : -1;
  int deepest = k;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    deepest = max(deepest, __shfl_xor_sync(kFullMask, deepest, off));
  Vec3<T> go{T(0), T(0), T(0)}, gd = go, gtp = go;
  uint32_t k0 = 0, k1 = 0, id = 0;
  if (k >= 0) {
    k0 = static_cast<uint32_t>(__ldg(a.key));
    k1 = static_cast<uint32_t>(__ldg(a.key + 1));
    id = static_cast<uint32_t>(__ldg(a.ray_ids + i));
    seed(a, grad, i, k, gd, gtp);
  }

  // The top row's saved state and inputs, and the tape entry below it.
  int row = deepest - 1;
  Ahead<T> x{};
  Vec3<T> o{}, d{}, tp{};
  if (row >= 0 && row < k) {
    const T* s = save_row(a, row, i);
    o = load3(s, 0);
    d = load3(s, 1);
    tp = load3(s, 2);
    x = ahead(a, tape_at(a, row, i), k0, k1, id, row);
  }
  int rec_next = row >= 1 && row - 1 < k ? tape_at(a, row - 1, i) : -1;
  for (; row >= 0; --row) {
    // The row below's saved state and inputs, and the tape entry below
    // that, issued before this row's re-shade and adjoint.
    Ahead<T> xn{};
    Vec3<T> o_next{}, d_next{}, tp_next{};
    if (row >= 1 && row - 1 < k) {
      const T* s = save_row(a, row - 1, i);
      o_next = load3(s, 0);
      d_next = load3(s, 1);
      tp_next = load3(s, 2);
      xn = ahead(a, rec_next, k0, k1, id, row - 1);
    }
    const int rec_after =
        row >= 2 && row - 2 < k ? tape_at(a, row - 2, i) : -1;
    RowGrad<T> gr{};
    int64_t key = -1;
    bool sphere = true;
    if (row < k) {
      Bounce<T> b;
      shade_row(a, x, o, d, b);
      bounce_adjoint(a, b, o, d, tp, go, gd, gtp, gr);
      key = b.w.key;
      sphere = b.w.g.sphere;
    }
    add_row(sh, w, sum, a.ns, key, sphere, gr, lane);
    x = xn;
    o = o_next;
    d = d_next;
    tp = tp_next;
    rec_next = rec_after;
  }
}

template <class T>
__device__ __forceinline__ Vec3<T> shfl3(Vec3<T> v, int src) {
  return Vec3<T>{__shfl_sync(kFullMask, v.x, src),
                 __shfl_sync(kFullMask, v.y, src),
                 __shfl_sync(kFullMask, v.z, src)};
}

// Lane src's bounce, as far as bounce_adjoint and the sum read it.
template <class T>
__device__ __forceinline__ Bounce<T> shfl_bounce(const Bounce<T>& b,
                                                 int src) {
  Bounce<T> out{};
  const int flags = (b.w.g.sphere ? 1 : 0) | (b.s.alt ? 2 : 0) |
                    (b.s.outside ? 4 : 0) | (b.s.reflected ? 8 : 0);
  const int f = __shfl_sync(kFullMask, flags, src);
  out.w.g.sphere = (f & 1) != 0;
  out.s.alt = (f & 2) != 0;
  out.s.outside = (f & 4) != 0;
  out.s.reflected = (f & 8) != 0;
  out.w.g.a = shfl3(b.w.g.a, src);
  out.w.g.r = __shfl_sync(kFullMask, b.w.g.r, src);
  if (!out.w.g.sphere) {
    out.w.g.b = shfl3(b.w.g.b, src);
    out.w.g.c = shfl3(b.w.g.c, src);
  }
  out.w.m.type = __shfl_sync(kFullMask, b.w.m.type, src);
  out.w.m.fuzz = __shfl_sync(kFullMask, b.w.m.fuzz, src);
  out.w.m.ref_idx = __shfl_sync(kFullMask, b.w.m.ref_idx, src);
  out.w.key = __shfl_sync(kFullMask, b.w.key, src);
  out.h.t = __shfl_sync(kFullMask, b.h.t, src);
  out.h.p = shfl3(b.h.p, src);
  out.h.n = shfl3(b.h.n, src);
  out.ball = shfl3(b.ball, src);
  out.s.att = shfl3(b.s.att, src);
  return out;
}

// A deep ray's sweep (end >= kDeepRows), a whole warp on it: 32 rows at a
// time, lane l re-shades row top - 1 - l from the saved state, then every
// lane carries the adjoint down those rows (the same values in each lane,
// each row's bounce shuffled from its lane), and lane l keeps row top - 1
// - l's gradient; the warp adds the 32 rows' gradients at once.
template <class T>
__device__ __forceinline__ void sweep_deep(const ReplayArgs<T>& a,
                                           const T* grad, Shared& sh, int w,
                                           double* sum, int64_t i, int lane) {
  const int k = __ldg(a.end + i);
  const uint32_t k0 = static_cast<uint32_t>(__ldg(a.key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(a.key + 1));
  const uint32_t id = static_cast<uint32_t>(__ldg(a.ray_ids + i));
  Vec3<T> go{T(0), T(0), T(0)}, gd = go, gtp = go;
  seed(a, grad, i, k, gd, gtp);
  for (int top = k; top > 0; top -= 32) {
    const int r = top - 1 - lane;
    Bounce<T> b{};
    Vec3<T> o{}, d{}, tp{};
    if (r >= 0) {
      const T* s = save_row(a, r, i);
      o = load3(s, 0);
      d = load3(s, 1);
      tp = load3(s, 2);
      shade_row(a, ahead(a, tape_at(a, r, i), k0, k1, id, r), o, d, b);
    }
    RowGrad<T> mine{};
    int64_t key = -1;
    bool sphere = true;
    const int rows = top < 32 ? top : 32;
    for (int j = 0; j < rows; ++j) {
      const Bounce<T> bj = shfl_bounce(b, j);
      const Vec3<T> oj = shfl3(o, j), dj = shfl3(d, j), tpj = shfl3(tp, j);
      RowGrad<T> gr;
      bounce_adjoint(a, bj, oj, dj, tpj, go, gd, gtp, gr);
      if (lane == j) {
        mine = gr;
        key = bj.w.key;
        sphere = bj.w.g.sphere;
      }
    }
    add_row(sh, w, sum, a.ns, key, sphere, mine, lane);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    replay_backward_kernel(ReplayArgs<T> a, const T* grad, const int* hist,
                           const int* order, int* ticket, double* sum) {
  extern __shared__ double smem[];  // Shared
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int e = lane; e < kHotRows * kFields; e += 32)
    sh.sum[w][e / kFields][e % kFields] = 0.0;
  if (lane < kHotRows) sh.tag[w][lane] = kNoRow;
  if (threadIdx.x == 0) {
    int rays = 0, deep = 0;
    for (int r = 0; r < a.rows; ++r) {
      const int c = __ldg(hist + r);
      rays += c;
      deep += r >= kDeepRows ? c : 0;
    }
    sh.rays = rays;
    sh.deep = deep;
  }
  __syncthreads();
  const int rays = sh.rays, deep = sh.deep;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(ticket, 1);
    g = __shfl_sync(kFullMask, g, 0);
    if (g < deep) {
      sweep_deep(a, grad, sh, w, sum, __ldg(order + g), lane);
      continue;
    }
    const int64_t first = deep + static_cast<int64_t>(g - deep) * 32;
    if (first >= rays) break;
    const int64_t place = first + lane;
    sweep(a, grad, sh, w, sum, place < rays ? __ldg(order + place) : -1,
          lane);
  }
  flush_rows(sh, w, sum, a.ns, lane);
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

// The blocks of `kernel` the card holds at once, `bytes` of dynamic shared
// memory each.
template <class K>
cudaError_t resident_blocks(K kernel, int bytes, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  *blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  return err;
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
            int* end, int* hist, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && hist != nullptr && rows > 0)
    err = cudaMemsetAsync(hist, 0, rows * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const ReplayArgs<T> a =
        replay_args(sph, ns, tri, nt, origin, direction, ray_ids, key, tape,
                    stride, rows, max_depth, t_min, n, save, end);
    replay_forward_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(a, radiance,
                                                                 hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// K15's grid: the blocks the card holds at once.
template <class T>
int backward_grid(int* blocks) {
  return static_cast<int>(
      resident_blocks(replay_backward_kernel<T>, sizeof(Shared), blocks));
}

int order(const int* end, const int* hist, int rows, int64_t n, int* cursor,
          int* out, cudaStream_t s) {
  const int bytes = static_cast<int>(3 * rows * sizeof(int));
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(replay_order_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(
      (n + kOrderRays * kThreads - 1) / (kOrderRays * kThreads));
  replay_order_kernel<<<blocks, kThreads, bytes, s>>>(end, hist, rows, n,
                                                      cursor, out);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int backward(const T* sph, int64_t ns, const T* tri, int64_t nt,
             const int64_t* ray_ids, const int64_t* key, const int* tape,
             int64_t stride, int rows, int max_depth, double t_min,
             int64_t n, const T* save, const int* end, const int* hist,
             const T* grad, double* work, int* perm, T* grad_sph,
             T* grad_tri, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t sph_cols = ns * kSphereCols, cols = sph_cols + nt * kTriCols;
  // The float64 sum, then the order's cursors (rows) and K15's ticket.
  int* cursor = reinterpret_cast<int*>(work + cols);
  int* ticket = cursor + rows;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && cols > 0)
    err = cudaMemsetAsync(work, 0, cols * sizeof(double) +
                                       (rows + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && cols > 0 && rows > 0) {
    int e = order(end, hist, rows, n, cursor, perm, s);
    if (e != 0) return e;
    int grid = 1;
    e = backward_grid<T>(&grid);
    if (e != 0) return e;
    if (grid > blocks_for(n)) grid = blocks_for(n);
    const ReplayArgs<T> a = replay_args(
        sph, ns, tri, nt, static_cast<const T*>(nullptr),
        static_cast<const T*>(nullptr), ray_ids, key, tape, stride, rows,
        max_depth, t_min, n, const_cast<T*>(save), const_cast<int*>(end));
    replay_backward_kernel<T><<<grid, kThreads, sizeof(Shared), s>>>(
        a, grad, hist, perm, ticket, work);
  }
  if (cols > 0)
    round_kernel<T><<<blocks_for(cols), kThreads, 0, s>>>(work, sph_cols,
                                                          cols, grad_sph,
                                                          grad_tri);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K14 on `stream` over n rays (module comment): the payload
// tables (ns, 15) and (nt, 20), the camera rays origin, direction (n, 3),
// the ray ids (n,) int64, the key (2,) int64 on the device, the tape (rows
// of int32, row r of ray i at tape[r * stride + i]), the depth cap, t_min,
// and the outputs: the radiance (n, 3) and, where save is not null, the
// scratch (rows, n, 9), end (n,) int32 and the histogram hist (rows,)
// int32 (zeroed here) that K15 reads.  Launches nothing but the zeroing
// for n = 0.
int frt_replay_forward_f32(const float* sph, int64_t ns, const float* tri,
                           int64_t nt, const float* origin,
                           const float* direction, const int64_t* ray_ids,
                           const int64_t* key, const int* tape,
                           int64_t stride, int rows, int max_depth,
                           double t_min, int64_t n, float* radiance,
                           float* save, int* end, int* hist, void* stream) {
  return forward<float>(sph, ns, tri, nt, origin, direction, ray_ids, key,
                        tape, stride, rows, max_depth, t_min, n, radiance,
                        save, end, hist, stream);
}

int frt_replay_forward_f64(const double* sph, int64_t ns, const double* tri,
                           int64_t nt, const double* origin,
                           const double* direction, const int64_t* ray_ids,
                           const int64_t* key, const int* tape,
                           int64_t stride, int rows, int max_depth,
                           double t_min, int64_t n, double* radiance,
                           double* save, int* end, int* hist, void* stream) {
  return forward<double>(sph, ns, tri, nt, origin, direction, ray_ids, key,
                         tape, stride, rows, max_depth, t_min, n, radiance,
                         save, end, hist, stream);
}

// Launches K15 on `stream` (module comment): the forward's tables, ids,
// key, tape and scalars, its scratch, end and hist, the radiance's adjoint
// grad (n, 3); work, float64 of ns * 15 + nt * 20 + (rows + 2) / 2 (the
// sum, then the order's cursors and ticket as int32), and perm (n,) int32
// (the order); zeroes work, orders the rays, adds into the sum and rounds
// it into grad_sph (ns, 15) and grad_tri (nt, 20).
int frt_replay_backward_f32(const float* sph, int64_t ns, const float* tri,
                            int64_t nt, const int64_t* ray_ids,
                            const int64_t* key, const int* tape,
                            int64_t stride, int rows, int max_depth,
                            double t_min, int64_t n, const float* save,
                            const int* end, const int* hist,
                            const float* grad, double* work, int* perm,
                            float* grad_sph, float* grad_tri, void* stream) {
  return backward<float>(sph, ns, tri, nt, ray_ids, key, tape, stride, rows,
                         max_depth, t_min, n, save, end, hist, grad, work,
                         perm, grad_sph, grad_tri, stream);
}

int frt_replay_backward_f64(const double* sph, int64_t ns, const double* tri,
                            int64_t nt, const int64_t* ray_ids,
                            const int64_t* key, const int* tape,
                            int64_t stride, int rows, int max_depth,
                            double t_min, int64_t n, const double* save,
                            const int* end, const int* hist,
                            const double* grad, double* work, int* perm,
                            double* grad_sph, double* grad_tri,
                            void* stream) {
  return backward<double>(sph, ns, tri, nt, ray_ids, key, tape, stride, rows,
                          max_depth, t_min, n, save, end, hist, grad, work,
                          perm, grad_sph, grad_tri, stream);
}

// K15's order alone (the tests'): the rays of end (n,) with a miss row,
// deepest first, into perm from K14's hist (rows,); cursor (rows,) int32
// zeroed by the caller.
int frt_replay_order(const int* end, const int* hist, int rows, int64_t n,
                     int* cursor, int* perm, void* stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || rows == 0) return 0;
  return order(end, hist, rows, n, cursor, perm,
               static_cast<cudaStream_t>(stream));
}

// The blocks the card holds at once of K15 (backward = 1) or of K14
// (backward = 0), for float32 rays (f64 = 0) or float64 (1), into *blocks:
// K15's grid; K14's first wave.
int frt_replay_blocks(int backward, int f64, int* blocks) {
  if (backward)
    return f64 ? backward_grid<double>(blocks) : backward_grid<float>(blocks);
  return static_cast<int>(
      f64 ? resident_blocks(replay_forward_kernel<double>, 0, blocks)
          : resident_blocks(replay_forward_kernel<float>, 0, blocks));
}

}  // extern "C"
