// K9 and K10 on Hopper: the wavefront pass's shading and its regeneration,
// each one kernel in place of the ~250 elementwise torch ops a pass ran
// between the closest hit (K4, K5 or K6) and the next pass.
//
// K9 (`shade_pool_kernel`, `shade_trip_kernel`) is the device form of
// render/wavefront_pass.py::shade_plain: the body of a pass past its
// closest hit, which XLA fused into the loop body on the TPU
// (first_raytracer_tpu/render/regenerative.py:87-141 `body`,
// render/integrator.py:213-268 `bounce`, materials/scatter.py), with K7's
// draw folded in.  One thread a slot, everything in registers: the hit
// record re-solved from the winning primitive as render/integrator.py::
// recompute_hit does (spheres only, triangles only, or both with prim >= Ns
// a triangle), the dead or missing lane sanitised (p = 0, n = UP), the sky
// on a miss, the bounce's four uniforms (mega_common.cuh::draws4, domain 1
// + depth, the key read from its device tensor on every launch), the unit
// ball sample, the checker texture, and lambertian, metal and dielectric
// scatter with Schlick's term and the coin; then whether the path goes on.
//   - Trip mode updates the chunked batch's carry in place: origin,
//     direction, throughput, radiance, alive and segments, the depth a 0-d
//     tensor shared by the batch.
//   - Pool mode adds the slot's segment and its sky (on a miss) to its
//     output row.  Live slots hold distinct ray ids, so only the slot that
//     owns a row adds to it, and a dead slot adds nothing: bit-equal to
//     index_add_ of every slot with zeros.  The sky's add is an atomic on
//     the card all the same, for its rounding: torch's CUDA index_add_
//     flushes a subnormal sum to zero (`index_add`).  It then writes
//     whether each slot continues (`cont`) and, for a slot that does, its
//     next state (its hit point, its scattered direction, tp *
//     attenuation, its id and depth + 1) to scratch rows, which K10 reads
//     for those slots only; a row of a slot that ends keeps what it held.
//     Each block writes its count of slots that continue (a ballot a
//     warp), K10's offsets.
//   - A dead slot is not shaded in either mode: it reads its liveness
//     and, in pool mode, writes cont = 0.
//
// K10 (`regenerate_kernel`) is the device form of
// render/wavefront_pass.py::regenerate_plain, the pool's compaction and
// regeneration, with K8's camera rays folded in.  One thread a slot, in
// the blocks of K9's launch.  The plain compaction's scan (a torch cumsum
// of `cont`, two graph nodes and 0.0077 ms at 2^17 slots, more than K10
// itself: chip_smoke.py phase 21) is done inside: a block sums K9's
// counts of the blocks before it (its offset) and of all of them
// (n_alive), and its slots' own prefix by a ballot a warp.  Every block
// reads every count, so the scan's reads grow as the square of the blocks:
// 2^18 four-byte reads (1 MB from L2) a launch at the 2^17 slots it is
// measured at, 2^24 (64 MB) at 2^20 slots and 2^28 at 2^22, where they
// would cost about what the rest of K10 does.  A survivor
// writes its next state to its compacted slot; a slot s at or past n_alive
// makes the camera ray of ray id start_id + clamp(cursor + s - n_alive)
// (camera_rays.cuh, K8's arithmetic) and resets its throughput, depth, id
// and liveness.  The two sets of slots are disjoint and K10 reads only K9's
// scratch rows, so the state is updated in place.  The cursor and the
// pool's first id are read from device tensors; thread 0 writes the
// advanced cursor to its own buffer, so no launch reads and writes the
// same word.  Camera rays are made for the tail only, not for every slot.
//
// Bit-equality.  Each operation rounds as torch rounds it on the device the
// kernel runs on (probes/torch_arith.py): torch.sum over a row of three
// adds (x + z) + y on the card and (x + y) + z on the CPU, and torch.prod
// multiplies (x * z) * y and (x * y) * z (frt::sum3, prod3); torch.linalg.
// cross is fma(a, b, -(c * d)) on both; 1.0 / x, (p - c) / r and (1 - n) /
// (1 + n) are IEEE divisions; x ** 5 is powf(x, 5); the ball's cube root is
// the float64 pow(u, 1/3) rounded to float32; sqrtf, sinf and cosf are
// torch's float32 ones on the card and, in the host build, the double ones
// rounded once (core/vecmath.py's on the CPU; the tests patch the bare
// torch.sqrt of normalize and of the sphere root).  Every other operation is
// one rounding, in torch's order, and the file is built with --fmad=false
// like the other kernels.  torch.clamp keeps a NaN; so do the selects here.
//
// Bounds on an H100 (utils/roofline.py): K9 reads every slot's liveness
// and a live one's ray, throughput, id, depth and closest hit (57 bytes in
// pool mode), writes `cont` and a surviving slot's scratch row (52), against
// K7's 164 integer operations of the draw and at least 60 FP32 operations
// of the recompute and the scatter a live slot: bound by bytes.  K10 reads
// `cont` (1 byte a slot), the block counts (4 bytes a block, for every
// block) and a survivor's scratch row (52) and writes every slot's state
// (53); a tail slot adds K8's draw and ray: bound by bytes.  The material
// table (11 words a row) is read through the read-only cache (__ldg):
// staged in shared memory instead, K9 took 0.0101 against 0.0089 ms at
// 2^17 slots of the final scene (PERF.md).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"

namespace {

using frt::CameraFields;
using frt::sum3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kBig = 1e30f;
constexpr float kDetEps = 1e-9f;
constexpr float kNormEps = 1e-20f;
constexpr int kMetal = 1;
constexpr int kDielectric = 2;
constexpr int kChecker = 1;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ void store3(float* __restrict__ p, int64_t i,
                                       V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 v) {
  return V3{s * v.x, s * v.y, s * v.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}

// vecmath.dot: torch.sum(a * b, dim=-1).
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.prod over a row of three, in the order of the device it runs on.
__device__ __forceinline__ float prod3(float x, float y, float z) {
#if defined(__CUDA_ARCH__)
  return (x * z) * y;
#else
  return (x * y) * z;
#endif
}

// vecmath.cross: torch.linalg.cross, each component fma(a, b, -(c * d)).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x))};
}

// vecmath.normalize(v, eps): the squared length floored at eps (a NaN
// kept), then v * (1 / sqrt(n2)) where n2 > 0, else 0.
__device__ __forceinline__ V3 normalize(V3 v, float eps) {
  float n2 = dot(v, v);
  if (eps > 0.0f) n2 = n2 < eps ? eps : n2;
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
  return scale(inv, v);
}

// geometry/sphere.py::sphere_hit_one on the oc form.
__device__ __forceinline__ float sphere_t(V3 o, V3 d, V3 c, float r,
                                          float t_min) {
  const V3 oc = sub(o, c);
  const float b = dot(oc, d);
  const float cc = dot(oc, oc) - r * r;
  const float disc = b * b - cc;
  const bool has = disc > 0.0f;
  const float sq = sqrtf(has ? disc : 0.0f);
  const float tn = -b - sq;
  const float tf = -b + sq;
  const bool near_ok = has && tn > t_min && tn < kBig;
  const bool far_ok = has && tf > t_min && tf < kBig;
  return near_ok ? tn : (far_ok ? tf : kBig);
}

// geometry/triangle.py::_moller_trumbore, kBig on a miss.
__device__ __forceinline__ float triangle_t(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                            float t_min) {
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool ok = fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const V3 tvec = sub(o, v0);
  const float u = dot(tvec, pvec) * inv;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv;
  const float t = dot(e2, qvec) * inv;
  const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                   t > t_min && t < kBig;
  return hit ? t : kBig;
}

// The scene's tensors (scene/soa.py::Scene), each its own.
struct SceneArgs {
  const float* sph_center;  // (ns, 3)
  const float* sph_radius;  // (ns,)
  const int* sph_mat;       // (ns,)
  const float* tri_v0;      // (nt, 3)
  const float* tri_v1;
  const float* tri_v2;
  const int* tri_mat;  // (nt,)
  const int* mat_type;  // (nm,)
  const int* tex_type;  // (nm,)
  const float* albedo;  // (nm, 3)
  const float* albedo2;
  const float* tex_scale;  // (nm,)
  const float* fuzz;
  const float* ref_idx;
  int ns, nt, nm;
};

// One slot's pass past its closest hit.
struct Shaded {
  bool hit;      // the recompute's hit, sanitised
  bool ok;       // the scatter's (a metal ray absorbed below its surface)
  V3 p;          // the hit point (0 on a miss)
  V3 dir;        // the scattered direction
  V3 att;        // the attenuation
};

__device__ __forceinline__ Shaded shade_slot(const SceneArgs& sc, V3 o,
                                             V3 d, int prim, bool hit_in,
                                             uint32_t k0, uint32_t k1,
                                             uint32_t id, uint32_t dom,
                                             float t_min) {
  // render/integrator.py::recompute_hit.
  const int64_t pr = prim;
  const bool is_sph = sc.nt == 0 || (sc.ns > 0 && pr < sc.ns);
  float t;
  V3 p, n;
  int m;
  if (is_sph) {
    const int64_t si = pr < 0 ? 0 : (pr > sc.ns - 1 ? sc.ns - 1 : pr);
    const V3 c = load3(sc.sph_center, si);
    const float r = __ldg(sc.sph_radius + si);
    t = sphere_t(o, d, c, r, t_min);
    p = add(o, scale(t, d));
    const V3 pc = sub(p, c);
    n = V3{pc.x / r, pc.y / r, pc.z / r};
    m = __ldg(sc.sph_mat + si);
  } else {
    const int64_t q = pr - sc.ns;
    const int64_t ti = q < 0 ? 0 : (q > sc.nt - 1 ? sc.nt - 1 : q);
    const V3 v0 = load3(sc.tri_v0, ti);
    const V3 e1 = sub(load3(sc.tri_v1, ti), v0);
    const V3 e2 = sub(load3(sc.tri_v2, ti), v0);
    t = triangle_t(o, d, v0, e1, e2, t_min);
    p = add(o, scale(t, d));
    n = normalize(cross(e1, e2), 0.0f);
    m = __ldg(sc.tri_mat + ti);
  }
  // Dead and missing lanes get sanitised hit data.
  Shaded s;
  s.hit = hit_in && t < kBig;
  if (!s.hit) {
    p = V3{0.0f, 0.0f, 0.0f};
    n = V3{0.0f, 0.0f, 1.0f};
  }
  s.p = p;

  // The bounce's draws and core/rng.py::unit_ball_sample.
  float u[4];
  frt::draws4(k0, k1, id, dom, u);
  const float z = 1.0f - 2.0f * u[0];
  const float rr = 1.0f - z * z;
  const float r = sqrtf(rr < 0.0f ? 0.0f : rr);
  const float phi = frt::kTwoPi * u[1];
  const float radius = static_cast<float>(
      pow(static_cast<double>(u[2]), 1.0 / 3.0));
  const V3 ball{radius * (r * cosf(phi)), radius * (r * sinf(phi)),
                radius * z};

  // materials/scatter.py::scatter_from_params, the material's branch only.
  const int mtype = __ldg(sc.mat_type + m);
  if (mtype == kDielectric) {
    const float ref = __ldg(sc.ref_idx + m);
    const float dn = dot(d, n);
    const V3 reflected = sub(d, scale(2.0f * dn, n));
    const bool outside = dn > 0.0f;
    const V3 on = outside ? V3{-n.x, -n.y, -n.z} : n;
    const float ni = outside ? ref : 1.0f / ref;
    const float cosine = outside ? ref * dn : -dn;
    // vecmath.refract(d, on, ni).
    const V3 uv = normalize(d, 0.0f);
    const float dt = dot(uv, on);
    const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
    const bool can = disc > 0.0f;
    const float sq = sqrtf(can ? disc : 0.0f);
    const V3 refr = can ? sub(scale(ni, sub(uv, scale(dt, on))), scale(sq, on))
                        : V3{0.0f, 0.0f, 0.0f};
    // vecmath.schlick(cosine, ref).
    float r0 = (1.0f - ref) / (1.0f + ref);
    r0 = r0 * r0;
    const float one_minus = 1.0f - cosine;
    const float prob = can ? r0 + (1.0f - r0) * powf(one_minus, 5.0f) : 1.0f;
    s.dir = normalize(u[3] < prob ? reflected : refr, kNormEps);
    s.att = V3{1.0f, 1.0f, 1.0f};
    s.ok = true;
    return s;
  }
  // scene/textures.py::texture_from_params.
  V3 tex = load3(sc.albedo, m);
  if (__ldg(sc.tex_type + m) == kChecker) {
    const float sc_ = __ldg(sc.tex_scale + m);
    const float sines =
        prod3(sinf(sc_ * p.x), sinf(sc_ * p.y), sinf(sc_ * p.z));
    if (sines < 0.0f) tex = load3(sc.albedo2, m);
  }
  s.att = tex;
  if (mtype == kMetal) {
    const float fz = __ldg(sc.fuzz + m);
    const V3 reflected = sub(d, scale(2.0f * dot(d, n), n));
    const V3 raw = add(reflected, scale(fz, ball));
    s.ok = dot(raw, n) > 0.0f;
    s.dir = normalize(raw, kNormEps);
  } else {
    s.ok = true;
    s.dir = normalize(add(n, ball), kNormEps);
  }
  return s;
}

// One value of index_add_ into an output row: on the card an atomic add,
// which rounds to nearest and flushes a subnormal input or result to zero,
// as torch's CUDA index_add_ adds; on the host a plain add, as its CPU one
// does (probes/torch_arith.py).  Only the row's owner adds, so the atomic
// meets no other.
__device__ __forceinline__ void index_add(float* p, float v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// How many threads of the block pass `pred`, in thread 0 (every thread of
// the block calls it, converged).
__device__ __forceinline__ int block_count(bool pred) {
  __shared__ int warp_counts[kWarps];
  const unsigned ballot = __ballot_sync(kFullMask, pred);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
  return total;
}

// render/integrator.py::sky_color, times the throughput.
__device__ __forceinline__ V3 sky(V3 tp, V3 d) {
  const float t = 0.5f * (d.y + 1.0f);
  const float w = 1.0f - t;
  return mul(tp, V3{w * 1.0f + t * 0.5f, w * 1.0f + t * 0.7f,
                    w * 1.0f + t * 1.0f});
}

// What every launch of K9 shares.
struct PassArgs {
  const int64_t* key;  // (2,)
  const int* prim;     // (C,)
  const uint8_t* hit;  // (C,) bool
  int64_t n;           // slots
  int max_depth;
  float t_min;
};

// Pool mode.  The pool's state (render/regenerative.py::pool_state): ray o,
// d, tp (C, 3), ids, depth (C,) int64, alive (C,) bool; the output rows
// (num_rays, 3) and segments (num_rays,) int32; the scratch rows K10 reads.
struct PoolArgs {
  const float* o;
  const float* d;
  const float* tp;
  const int64_t* ids;
  const int64_t* depth;
  const uint8_t* alive;
  const int64_t* start_id;  // 0-d
  int64_t num_rays;
  float* out;
  int* segments;
  float* next_o;
  float* next_d;
  float* next_tp;
  int64_t* next_ids;
  int64_t* next_depth;
  uint8_t* cont;
  int* block_counts;  // (blocks,): each block's slots that continue
};

__device__ __forceinline__ bool shade_pool_slot(const SceneArgs& sc,
                                                const PassArgs& a,
                                                const PoolArgs& q,
                                                int64_t i) {
  if (__ldg(q.alive + i) == 0) {  // a dead slot adds nothing and ends
    q.cont[i] = 0;
    return false;
  }
  const V3 o = load3(q.o, i), d = load3(q.d, i), tp = load3(q.tp, i);
  const int64_t id = __ldg(q.ids + i);
  const int64_t depth = __ldg(q.depth + i);
  int64_t row = id - __ldg(q.start_id);
  row = row < 0 ? 0 : (row > q.num_rays - 1 ? q.num_rays - 1 : row);
  const Shaded s = shade_slot(
      sc, o, d, __ldg(a.prim + i), __ldg(a.hit + i) != 0,
      static_cast<uint32_t>(__ldg(a.key)), static_cast<uint32_t>(__ldg(a.key + 1)),
      static_cast<uint32_t>(id), static_cast<uint32_t>(depth + 1), a.t_min);
  q.segments[row] += 1;
  if (!s.hit) {
    const V3 add_ = sky(tp, d);
    index_add(q.out + 3 * row, add_.x);
    index_add(q.out + 3 * row + 1, add_.y);
    index_add(q.out + 3 * row + 2, add_.z);
  }
  const bool cont = s.hit && s.ok && depth < a.max_depth;
  q.cont[i] = cont;
  if (cont) {  // K10 reads the scratch rows of these slots only
    store3(q.next_o, i, s.p);
    store3(q.next_d, i, s.dir);
    store3(q.next_tp, i, mul(tp, s.att));
    q.next_ids[i] = id;
    q.next_depth[i] = depth + 1;
  }
  return cont;
}

__global__ void __launch_bounds__(kThreads)
    shade_pool_kernel(SceneArgs sc, PassArgs a, PoolArgs q) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool cont = i < a.n && shade_pool_slot(sc, a, q, i);
  const int count = block_count(cont);
  if (threadIdx.x == 0) q.block_counts[blockIdx.x] = count;
}

// Trip mode.  The chunked batch's carry (render/integrator.py::trace_state):
// origin, direction, throughput, radiance (R, 3), alive (R,) bool, segments
// (R,) int32, the ray ids (R,) int64 and the batch's depth (0-d int64).
struct TripArgs {
  float* origin;
  float* direction;
  float* throughput;
  float* radiance;
  uint8_t* alive;
  int* segments;
  const int64_t* ray_ids;
  const int64_t* depth;  // 0-d
};

__global__ void __launch_bounds__(kThreads)
    shade_trip_kernel(SceneArgs sc, PassArgs a, TripArgs q) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n || q.alive[i] == 0) return;  // a dead ray's carry stays
  const V3 o = load3(q.origin, i), d = load3(q.direction, i);
  const V3 tp = load3(q.throughput, i);
  const int64_t depth = __ldg(q.depth);
  const Shaded s = shade_slot(
      sc, o, d, __ldg(a.prim + i), __ldg(a.hit + i) != 0,
      static_cast<uint32_t>(__ldg(a.key)), static_cast<uint32_t>(__ldg(a.key + 1)),
      static_cast<uint32_t>(__ldg(q.ray_ids + i)),
      static_cast<uint32_t>(depth + 1), a.t_min);
  q.segments[i] += 1;
  if (!s.hit) {
    const V3 add_ = sky(tp, d);
    q.radiance[3 * i] += add_.x;
    q.radiance[3 * i + 1] += add_.y;
    q.radiance[3 * i + 2] += add_.z;
  }
  const bool cont = s.hit && s.ok && depth < a.max_depth;
  if (cont) {
    store3(q.throughput, i, mul(tp, s.att));
    store3(q.origin, i, s.p);
    store3(q.direction, i, s.dir);
  }
  q.alive[i] = cont;
}

// K10.  The pool's state, written in place, K9's scratch rows and block
// counts, the camera and the stream's cursor.
struct RegenArgs {
  const int64_t* key;  // (2,)
  CameraFields<float> cam;
  int64_t nx, ny, spp, image_rays;  // the image's rays (fresh ids clamp)
  float* o;
  float* d;
  float* tp;
  int64_t* ids;
  int64_t* depth;
  uint8_t* alive;
  const float* next_o;
  const float* next_d;
  const float* next_tp;
  const int64_t* next_ids;
  const int64_t* next_depth;
  const uint8_t* cont;
  const int* block_counts;  // (blocks,): K9's, in K9's blocks
  int blocks;
  const int64_t* cursor;    // 0-d
  const int64_t* start_id;  // 0-d
  int64_t* cursor_next;     // 0-d
  int64_t num_rays;
  int64_t n;  // slots
};

__global__ void __launch_bounds__(kThreads)
    regenerate_kernel(RegenArgs a) {
  __shared__ int warp_before[kWarps], warp_total[kWarps], warp_counts[kWarps];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool cont = i < a.n && __ldg(a.cont + i) != 0;
  // The survivors of the blocks before this one and of all of them.
  int before = 0, total = 0;
  for (int b = threadIdx.x; b < a.blocks; b += kThreads) {
    const int c = __ldg(a.block_counts + b);
    total += c;
    if (b < static_cast<int>(blockIdx.x)) before += c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(kFullMask, before, off);
    total += __shfl_xor_sync(kFullMask, total, off);
  }
  // This slot's survivors before it in its block, by a ballot a warp.
  const unsigned ballot = __ballot_sync(kFullMask, cont);
  if (lane == 0) {
    warp_before[warp] = before;
    warp_total[warp] = total;
    warp_counts[warp] = __popc(ballot);
  }
  __syncthreads();
  int64_t n_alive = 0, dest = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < kWarps; ++w) {
    n_alive += warp_total[w];
    dest += warp_before[w] + (w < warp ? warp_counts[w] : 0);
  }
  if (i >= a.n) return;
  const int64_t cursor = __ldg(a.cursor);
  if (cont) {
    store3(a.o, dest, load3(a.next_o, i));
    store3(a.d, dest, load3(a.next_d, i));
    store3(a.tp, dest, load3(a.next_tp, i));
    a.ids[dest] = __ldg(a.next_ids + i);
    a.depth[dest] = __ldg(a.next_depth + i);
    a.alive[dest] = 1;
  }
  if (i >= n_alive) {
    const int64_t fresh = cursor + i - n_alive;
    const int64_t idx =
        fresh < 0 ? 0 : (fresh > a.num_rays - 1 ? a.num_rays - 1 : fresh);
    const int64_t id = __ldg(a.start_id) + idx;
    const int64_t cam_id =
        id < 0 ? 0 : (id > a.image_rays - 1 ? a.image_rays - 1 : id);
    float o[3], d[3];
    frt::torch_camera_ray<float>(static_cast<uint32_t>(__ldg(a.key)),
                                 static_cast<uint32_t>(__ldg(a.key + 1)),
                                 cam_id, a.nx, a.ny, a.spp, a.cam, o, d);
    store3(a.o, i, V3{o[0], o[1], o[2]});
    store3(a.d, i, V3{d[0], d[1], d[2]});
    store3(a.tp, i, V3{1.0f, 1.0f, 1.0f});
    a.depth[i] = 0;
    a.ids[i] = id;
    a.alive[i] = fresh < a.num_rays;
  }
  if (i == 0) {
    const int64_t left = a.num_rays - cursor;
    const int64_t room = a.n - n_alive;
    *a.cursor_next = cursor + (room < (left < 0 ? 0 : left)
                                   ? room
                                   : (left < 0 ? 0 : left));
  }
}

int blocks_for(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

SceneArgs scene_args(const float* sph_center, const float* sph_radius,
                     const int* sph_mat, const float* tri_v0,
                     const float* tri_v1, const float* tri_v2,
                     const int* tri_mat, int ns, int nt, const int* mat_type,
                     const int* tex_type, const float* albedo,
                     const float* albedo2, const float* tex_scale,
                     const float* fuzz, const float* ref_idx, int nm) {
  return SceneArgs{sph_center, sph_radius, sph_mat, tri_v0,  tri_v1,
                   tri_v2,     tri_mat,    mat_type, tex_type, albedo,
                   albedo2,    tex_scale,  fuzz,    ref_idx, ns,
                   nt,         nm};
}

}  // namespace

extern "C" {


// Launches K9 in pool mode on `stream` over n slots (module comment),
// writing each block's count of slots that continue to block_counts
// (one int32 a block of kThreads slots).  The
// scene: sph_center (ns, 3), sph_radius (ns,), sph_mat (ns,) int32, tri_v0,
// tri_v1, tri_v2 (nt, 3), tri_mat (nt,) int32, and the material table of nm
// rows: mat_type, tex_type (int32), albedo, albedo2 (nm, 3), tex_scale,
// fuzz, ref_idx.  Launches nothing for n = 0.  Returns cudaGetLastError()
// after the launch (0 = launched).
int frt_shade_pool(const int64_t* key, const float* sph_center,
                   const float* sph_radius, const int* sph_mat,
                   const float* tri_v0, const float* tri_v1,
                   const float* tri_v2, const int* tri_mat, int ns, int nt,
                   const int* mat_type, const int* tex_type,
                   const float* albedo, const float* albedo2,
                   const float* tex_scale, const float* fuzz,
                   const float* ref_idx, int nm, const float* o,
                   const float* d, const float* tp, const int64_t* ids,
                   const int64_t* depth, const uint8_t* alive,
                   const int* prim, const uint8_t* hit,
                   const int64_t* start_id, int64_t num_rays, int max_depth,
                   float t_min, float* out, int* segments, float* next_o,
                   float* next_d, float* next_tp, int64_t* next_ids,
                   int64_t* next_depth, uint8_t* cont, int* block_counts,
                   int64_t n, void* stream) {
  if (n > 0) {
    const SceneArgs sc = scene_args(sph_center, sph_radius, sph_mat, tri_v0,
                                    tri_v1, tri_v2, tri_mat, ns, nt,
                                    mat_type, tex_type, albedo, albedo2,
                                    tex_scale, fuzz, ref_idx, nm);
    const PassArgs a{key, prim, hit, n, max_depth, t_min};
    const PoolArgs q{o,        d,       tp,      ids,      depth,
                     alive,    start_id, num_rays, out,    segments,
                     next_o,   next_d,  next_tp, next_ids, next_depth,
                     cont,     block_counts};
    shade_pool_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(sc, a, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K9 in trip mode on `stream` over n rays: the scene as above,
// then the carry origin, direction, throughput, radiance (n, 3), alive (n,)
// bool, segments (n,) int32, updated in place, the ray ids (n,) int64 and
// the batch's depth (0-d int64).  Launches nothing for n = 0.
int frt_shade_trip(const int64_t* key, const float* sph_center,
                   const float* sph_radius, const int* sph_mat,
                   const float* tri_v0, const float* tri_v1,
                   const float* tri_v2, const int* tri_mat, int ns, int nt,
                   const int* mat_type, const int* tex_type,
                   const float* albedo, const float* albedo2,
                   const float* tex_scale, const float* fuzz,
                   const float* ref_idx, int nm, float* origin,
                   float* direction, float* throughput, float* radiance,
                   uint8_t* alive, int* segments, const int64_t* ray_ids,
                   const int64_t* depth, const int* prim, const uint8_t* hit,
                   int max_depth, float t_min, int64_t n, void* stream) {
  if (n > 0) {
    const SceneArgs sc = scene_args(sph_center, sph_radius, sph_mat, tri_v0,
                                    tri_v1, tri_v2, tri_mat, ns, nt,
                                    mat_type, tex_type, albedo, albedo2,
                                    tex_scale, fuzz, ref_idx, nm);
    const PassArgs a{key, prim, hit, n, max_depth, t_min};
    const TripArgs q{origin, direction, throughput, radiance,
                     alive,  segments,  ray_ids,    depth};
    shade_trip_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(sc, a, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K10 on `stream` over the pool's n slots (module comment): the
// key, the camera's seven float32 fields, the image's size (nx, ny, spp),
// the pool's state o, d, tp (n, 3), ids, depth (n,) int64, alive (n,) bool
// (written), K9's scratch rows and block counts, the cursor and the first
// id (0-d int64), the advanced cursor's buffer
// (0-d int64, written) and the stream's length num_rays.  Launches nothing
// for n = 0.
int frt_regenerate(const int64_t* key, const float* cam_origin,
                   const float* cam_lower_left, const float* cam_horizontal,
                   const float* cam_vertical, const float* cam_u,
                   const float* cam_v, const float* cam_lens_radius,
                   int64_t nx, int64_t ny, int64_t spp, float* o, float* d,
                   float* tp, int64_t* ids, int64_t* depth, uint8_t* alive,
                   const float* next_o, const float* next_d,
                   const float* next_tp, const int64_t* next_ids,
                   const int64_t* next_depth, const uint8_t* cont,
                   const int* block_counts, const int64_t* cursor,
                   const int64_t* start_id, int64_t* cursor_next,
                   int64_t num_rays, int64_t n, void* stream) {
  if (n > 0) {
    const CameraFields<float> cam{cam_origin, cam_lower_left, cam_horizontal,
                                  cam_vertical, cam_u,      cam_v,
                                  cam_lens_radius};
    const RegenArgs a{key,      cam,       nx,         ny,
                      spp,      nx * ny * spp, o,      d,
                      tp,       ids,       depth,      alive,
                      next_o,   next_d,    next_tp,    next_ids,
                      next_depth, cont,    block_counts, blocks_for(n),
                      cursor,   start_id,  cursor_next, num_rays, n};
    regenerate_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
