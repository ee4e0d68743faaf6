// K9 and K10 on Hopper: the wavefront pass's shading and compaction, and
// the pool's regeneration, each one kernel in place of the ~250 elementwise
// torch ops a pass ran between the closest hit (K4, K5, K6 or K11) and the
// next pass; K12 and K13, the same for the recorders' passes.
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
// A slot's chain of dependent loads is three deep: its whole state and
// closest hit at once (the liveness with the rest: a dead slot's reads are
// wasted, not waited for), then its primitive's geometry and material id
// together, then the material's whole row; the draw, which needs only the
// id and depth, is issued between the first two so that it runs while the
// geometry is in flight.  A dead slot is not shaded.
//   - Trip mode updates the chunked batch's carry in place: origin,
//     direction, throughput, radiance, alive and segments, the depth a 0-d
//     tensor shared by the batch.
//   - Pool mode adds the slot's segment and its sky (on a miss) to its
//     output row.  Live slots hold distinct ray ids, so only the slot that
//     owns a row adds to it, and a dead slot adds nothing: bit-equal to
//     index_add_ of every slot with zeros.  The sky's add is an atomic on
//     the card all the same, for its rounding: torch's CUDA index_add_
//     flushes a subnormal sum to zero (`index_add`).  It then compacts the
//     survivors to the front of the pool, in order, in place: a survivor's
//     next state (its hit point, its scattered direction, tp * attenuation,
//     its id, depth + 1, alive) goes straight to slot prefix + rank, where
//     prefix counts the survivors of the tiles before its own and rank
//     those before it in its tile.
//
// The scan is single-pass with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// NVR-2016-002).  A block takes its tile of kThreads slots from a ticket
// (an atomicAdd on the scan's first word), not from blockIdx, so every
// tile before its own belongs to a block that is already running.  Its
// threads read their slots, shade and ballot; after a __syncthreads warp 1
// publishes the tile's survivor count (flag aggregate; tile 0 its
// inclusive prefix) while warp 0 reads its predecessors' status words 32
// at a time, nearest first, spinning while a word nearer than the nearest
// inclusive prefix is not yet this pass's, and sums aggregates back to
// that prefix: its exclusive prefix.  After a second __syncthreads the
// block writes its survivors and warp 0 publishes its inclusive prefix.
// Status words are 64 bits:
// the count in the low 32, the flag in the next 2, the pass's epoch (its
// ticket / blocks) above, so a word of an earlier pass never reads as this
// one's and nothing has to be cleared between passes, by a kernel or a
// memset node of a CUDA graph.  Words are published with release stores
// and read relaxed, a fence after the look-back's last read making its
// reads acquire ones.  The tile holding the last ticket writes the pass
// record: the survivors in all (n_alive) and the cursor as the pass found
// it.
//
// Why the in-place writes are safe.  A survivor at slot i goes to slot
// prefix + rank <= i (at most i slots before it survive), so a destination
// is never past the end of its own block's tile.  A destination in the
// block's own tile was read before the block's first __syncthreads after
// the shading, and the writes come after it.  A destination in an earlier
// tile belongs to a block that published its aggregate before this block's
// look-back ended (a tile's inclusive prefix is published only after every
// tile before it has published; the look-back's acquire reads see the
// release stores that chain back to each of them), and a block publishes
// only after its first __syncthreads, that is after it has read all of its
// slots.  No block writes a slot that is still to be read.  Slots at or
// past n_alive are not written: K10 refills them.
//
// K10 (`regenerate_kernel`) is the device form of
// render/wavefront_pass.py::regenerate_plain: the pool's tail refilled with
// camera rays, with K8's arithmetic folded in (camera_rays.cuh).  It reads
// the pass record; thread g makes the camera ray of slot n_alive + g (ray
// id start_id + clamp(cursor + g)) and resets its throughput, depth, id and
// liveness; threads past the pool return at once.  Thread 0 writes the
// advanced cursor into the cursor itself: K10 reads the old value from the
// record, so no launch reads and writes the same word, and no copy follows.
//
// K12 and K13 are the same pass for the gradient step's recorders, the
// device forms of diff/record_pass.py's plain seams, which replace the
// recorders' loop bodies that XLA fused (first_raytracer_tpu/diff/
// replay.py:92-110 lockstep, :155-206 pool, utils/metrics.py:29 the
// occupancy scan).  K12 shades a live ray with K9's shade_slot at bounce d
// (+1 for the draw's domain).
//   - Lockstep and length modes (`record_step_kernel`) run every ray of the
//     recorder's state at every bounce, most of them dead past the first two
//     (3% live or less over the last ~40 of a direct step's bounces).  So a
//     block takes a window of kStepWindow rays, reads its liveness four bytes
//     a thread, packs the live rays' places in order into shared memory
//     (ballots for a lane's rank in its warp, each warp's rays in a segment of
//     its own, so the block meets at one barrier) and shades only them,
//     kStepRays a thread, in full warps: a dead ray's state and closest hit
//     are never read, and a warp with no live entry shades nothing.  Lockstep
//     mode writes tape row min(d, max_depth + 1) whole (the winner where the
//     ray was alive within the depth cap and the recompute hit, else -1): a
//     dead ray's entry from the thread that read its liveness, four in one
//     store where it can, a live ray's from the thread that shades it; length
//     mode adds one to a live ray's length; a continuing ray's o and dr move
//     in place.  The bounce counter d (0-d) is advanced by the launch itself:
//     every block reads it, then arrives on an arrival word, and the last to
//     arrive adds one and clears the word, so no graph needs a node for the
//     add or a memset, and no block reads a moved counter.
//   - Pool mode (`record_pool_kernel`) writes a hit's flat tape entry depth
//     * R + col (live slots hold distinct columns), compacts the survivors'
//     o, d, id, column and depth + 1 in place through K9's scan
//     (look_back; its own status words, a tile of kRecordTile slots each),
//     and then, with K13 folded into the same launch, refills the tail
//     [n_alive, C): each slot's id gathered from the stream
//     (ray_ids[clamp(cursor + g)]), its camera ray (camera_rays.cuh), its
//     column, depth 0 and liveness; the cursor advances.  The grid is
//     persistent (at most the blocks the card holds at once) and a block
//     takes tiles by ticket in a loop (take_tile), so a look-back waits only
//     on tiles whose blocks are running; a pass takes one ticket a tile and
//     one a block that finds the tiles gone, and the epoch of its status
//     words is its ticket over that.  The last tile writes the pass record
//     (n_alive, the cursor as the pass found it) before it publishes its
//     inclusive prefix, which is n_alive, with release; every block waits
//     for that word of this pass's epoch, then reads the record and
//     refills its share of the tail.  The in-place writes stay safe: a
//     survivor goes to a slot below n_alive, as in K9 (below), so a tail
//     slot is never a compaction destination; and a tile publishes only
//     after it has read all of its slots, so once the last tile's inclusive
//     prefix is out (it follows every tile's aggregate: the look-backs'
//     acquire reads chain back to each), every slot has been read, and the
//     tail's writes overwrite nothing still to be read.
// All three are bound by bytes, as K9 and K10 are (utils/roofline.py).
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
// Reordering loads changes no rounding.
//
// Bounds on an H100 (utils/roofline.py): K9 reads every slot's state and
// closest hit (57 bytes in pool mode), a live slot's segment count (read
// and written) and a miss's output row, and writes a survivor's next state
// (53) and a tile's status word twice, against K7's 164 integer operations
// of the draw and at least 60 FP32 operations of the recompute and the
// scatter a live slot: bound by bytes.  K10 writes a tail slot's state
// (53) from K8's draw and ray: bound by bytes.  The material table (11
// words a row) is read through the read-only cache (__ldg): staged in
// shared memory instead, K9 took 0.0101 against 0.0089 ms at 2^17 slots of
// the final scene (PERF.md).
//
// probes/k9_chain.py builds variants of K9 that split one slot's time:
// FRT_K9_NO_DRAW (constant uniforms), FRT_K9_CONST_GATHERS (the primitive
// and its material replaced by constants) and FRT_K9_ALIVE_FIRST (a
// slot's liveness read and tested before its other fields, as before the
// redesign), and others of the scan by editing a copy of this file.  The
// first two give wrong results; the package defines none.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "camera_rays.cuh"
#include "mega_common.cuh"
#include "shade.cuh"
#include "torch_hits.cuh"

namespace {

using frt::CameraFields;
using frt::sum3;
using namespace frt::th;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kBig = 1e30f;

// A status word of the look-back: the count in bits 0-31, the flag in bits
// 32-33 (0: not this pass's yet), the pass's epoch in bits 34-63.
using Word = unsigned long long;
constexpr Word kCountMask = 0xffffffffull;
constexpr Word kFlagMask = 3ull << 32;
constexpr Word kAggregate = 1ull << 32;
constexpr Word kPrefix = 2ull << 32;
constexpr int kEpochShift = 34;
constexpr Word kEpochMask = (1ull << 30) - 1;

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

// The winning primitive's rows: its geometry (shade.cuh::Geom) and its
// material id.
struct Prim : Geom<float> {
  int m;
};

// render/integrator.py::recompute_hit's gather, geometry and material id
// in one step.
__device__ __forceinline__ Prim gather_prim(const SceneArgs& sc, int prim) {
  const int64_t pr = prim;
  Prim g;
  g.sphere = sc.nt == 0 || (sc.ns > 0 && pr < sc.ns);
#if defined(FRT_K9_CONST_GATHERS)
  g.a = V3{0.0f, 0.0f, -1.0f};
  g.b = V3{1.0f, 0.0f, -1.0f};
  g.c = V3{0.0f, 1.0f, -1.0f};
  g.r = 0.5f;
  g.m = 0;
#else
  if (g.sphere) {
    const int64_t si = pr < 0 ? 0 : (pr > sc.ns - 1 ? sc.ns - 1 : pr);
    g.a = load3(sc.sph_center, si);
    g.r = __ldg(sc.sph_radius + si);
    g.m = __ldg(sc.sph_mat + si);
  } else {
    const int64_t q = pr - sc.ns;
    const int64_t ti = q < 0 ? 0 : (q > sc.nt - 1 ? sc.nt - 1 : q);
    g.a = load3(sc.tri_v0, ti);
    g.b = load3(sc.tri_v1, ti);
    g.c = load3(sc.tri_v2, ti);
    g.m = __ldg(sc.tri_mat + ti);
  }
#endif
  return g;
}

// A material's row (shade.cuh::Material), every field in one step.
__device__ __forceinline__ Material<float> gather_material(
    const SceneArgs& sc, int m) {
#if defined(FRT_K9_CONST_GATHERS)
  (void)sc;
  (void)m;
  return Material<float>{0, 0, V3{0.5f, 0.5f, 0.5f}, V3{0.5f, 0.5f, 0.5f},
                         1.0f, 0.0f, 1.5f};
#else
  return Material<float>{__ldg(sc.mat_type + m), __ldg(sc.tex_type + m),
                         load3(sc.albedo, m),    load3(sc.albedo2, m),
                         __ldg(sc.tex_scale + m), __ldg(sc.fuzz + m),
                         __ldg(sc.ref_idx + m)};
#endif
}

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
  const Prim g = gather_prim(sc, prim);

  // The bounce's draws and core/rng.py::unit_ball_sample, while the
  // primitive's rows are in flight.
  float u[4];
#if defined(FRT_K9_NO_DRAW)
  (void)k0;
  (void)k1;
  (void)dom;
  u[0] = u[1] = u[2] = u[3] = 0.5f - 0x1p-24f * static_cast<float>(id & 255u);
#else
  frt::draws4(k0, k1, id, dom, u);
#endif
  const V3 ball = ball_sample(u);

  // render/integrator.py::recompute_hit.
  const Surface<float> h = recompute<float>(g, o, d, t_min);
  const Material<float> mt = gather_material(sc, g.m);
  // Dead and missing lanes get sanitised hit data.
  Shaded s;
  s.hit = hit_in && h.t < kBig;
  const V3 p = s.hit ? h.p : V3{0.0f, 0.0f, 0.0f};
  const V3 n = s.hit ? h.n : V3{0.0f, 0.0f, 1.0f};
  s.p = p;

  // materials/scatter.py::scatter_from_params, the material's branch only.
  const Scattered<float> sc_ = scatter(mt, d, p, n, ball, u[3]);
  s.ok = sc_.ok;
  s.dir = sc_.dir;
  s.att = sc_.att;
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

// A status word published with release semantics, and read relaxed (a
// fence after the look-back's last read makes its reads acquire ones), at
// the scope of the device.
__device__ __forceinline__ void publish(Word* p, Word v) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  __threadfence();
  *reinterpret_cast<volatile Word*>(p) = v;
#endif
}
__device__ __forceinline__ Word peek(const Word* p) {
#if defined(__CUDA_ARCH__)
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
#else
  return *reinterpret_cast<const volatile Word*>(p);
#endif
}

// Status words a look-back reads at once: kSpan a lane, lane l holding
// the tiles 32 * j + l back, nearest first (probes/k9_chain.py: 2 was no
// faster at 2^17 slots, 4 and 8 slower).
constexpr int kSpan = 1;
constexpr int kWindow = 32 * kSpan;

// The exclusive prefix of tile `tile` (> 0), whose aggregate is published:
// warp 0 reads the kWindow tiles before `end` (= tile at first), nearest
// first, until every word nearer than the nearest inclusive prefix holds
// this epoch's word (spinning while one does not), then sums the
// aggregates up to that prefix, or all kWindow and goes on kWindow tiles
// back.  Tile 0 always holds an inclusive prefix, so the walk ends.  Every
// lane of warp 0 returns the prefix.
__device__ __forceinline__ int64_t look_back(const Word* status, int tile,
                                             Word epoch) {
  const int lane = threadIdx.x & 31;
  int64_t prefix = 0;
  for (int end = tile;; end -= kWindow) {
    Word w[kSpan];
    bool ready[kSpan];
    for (int j = 0; j < kSpan; ++j) {
      w[j] = 0;
      ready[j] = end - 1 - lane - 32 * j < 0;  // past tile 0: never read
    }
    int stop;  // the nearest inclusive prefix's position, kWindow if none
    for (;;) {
      unsigned waiting[kSpan], inclusive[kSpan];
      for (int j = 0; j < kSpan; ++j) {
        const int pred = end - 1 - lane - 32 * j;
        if (!ready[j]) {
          w[j] = peek(status + pred);
          ready[j] = (w[j] >> kEpochShift) == epoch &&
                     (w[j] & kFlagMask) != 0;
        }
        waiting[j] = __ballot_sync(kFullMask, !ready[j]);
        inclusive[j] = __ballot_sync(kFullMask, pred >= 0 && ready[j] &&
                                                    (w[j] & kFlagMask) ==
                                                        kPrefix);
      }
      stop = kWindow;
      bool blocked = false;  // a word nearer than `stop` not yet this pass's
      for (int j = 0; j < kSpan && stop == kWindow; ++j) {
        const int first = __ffs(static_cast<int>(inclusive[j])) - 1;
        const unsigned nearer = inclusive[j] ? (1u << first) - 1u : kFullMask;
        blocked = blocked || (waiting[j] & nearer) != 0;
        if (inclusive[j]) stop = 32 * j + first;
      }
      if (!blocked) break;
      __nanosleep(32);
    }
#if defined(FRT_HOST_EMU)  // what the emulation's look-backs meet
    if (lane == 0) frt_emu::note_window(stop, stop == kWindow);
#endif
    int64_t v = 0;
    for (int j = 0; j < kSpan; ++j)
      if (end - 1 - lane - 32 * j >= 0 && lane + 32 * j <= stop)
        v += static_cast<int64_t>(w[j] & kCountMask);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFullMask, v, off);
    prefix += v;
    if (stop < kWindow) {
      __threadfence();  // the reads above become acquire reads
      return prefix;
    }
  }
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
// d, tp (C, 3), ids, depth (C,) int64, alive (C,) bool, compacted in place;
// the output rows (num_rays, 3) and segments (num_rays,) int32; the
// cursor; the pass record K9 writes for K10 (n_alive, the cursor); the
// scan's ticket and status words.
struct PoolArgs {
  float* o;
  float* d;
  float* tp;
  int64_t* ids;
  int64_t* depth;
  uint8_t* alive;
  const int64_t* start_id;  // 0-d
  int64_t num_rays;
  float* out;
  int* segments;
  const int64_t* cursor;  // 0-d
  int64_t* record;        // (2,)
  Word* scan;             // (1 + blocks,): the ticket, a word a tile
};

// A block's shared memory in pool mode (dynamic, so that the host
// emulation gives each block its own).
struct PoolShared {
  Word ticket;
  int64_t prefix;  // the tile's exclusive prefix
  int warp_counts[kWarps];
};

// One slot's state and closest hit (pool mode), read in one step.
struct Slot {
  bool live, hit;
  V3 o, d, tp;
  int64_t id, depth;
  int prim;
};

__device__ __forceinline__ Slot load_slot(const PassArgs& a,
                                          const PoolArgs& q, int64_t i) {
  Slot s{};
  if (i < a.n) {
    s.live = q.alive[i] != 0;
#if defined(FRT_K9_ALIVE_FIRST)
    if (s.live)  // the liveness first, then the other fields
#endif
    {
      s.o = state3(q.o, i);
      s.d = state3(q.d, i);
      s.tp = state3(q.tp, i);
      s.id = q.ids[i];
      s.depth = q.depth[i];
      s.prim = __ldg(a.prim + i);
      s.hit = __ldg(a.hit + i) != 0;
    }
  }
  return s;
}

// The pool's tile and the pass's epoch, from the ticket the block takes.
struct Ticket {
  int tile;
  Word epoch;
};

__device__ __forceinline__ Ticket take_ticket(PoolShared& sh, Word* scan) {
  if (threadIdx.x == 0) sh.ticket = atomicAdd(scan, 1ull);
  __syncthreads();
  const Word blocks = gridDim.x;
  return Ticket{static_cast<int>(sh.ticket % blocks),
                (sh.ticket / blocks) & kEpochMask};
}

// The compaction's scan (module comment), called by every thread of the
// block once it has read its slot: the slot a survivor (`cont`) of this
// thread goes to, prefix + rank (meaningless for the others).  The tile of
// the last ticket writes the pass record (the survivors in all, the cursor
// as the pass found it).  On return every slot of the tile has been read
// and the tile's inclusive prefix is published.
__device__ __forceinline__ int64_t compact_slot(PoolShared& sh, Word* scan,
                                                Ticket tk, bool cont,
                                                int64_t* record,
                                                const int64_t* cursor) {
  Word* status = scan + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The tile's survivors: a ballot a warp, then the block's aggregate.
  const unsigned ballot = __ballot_sync(kFullMask, cont);
  if (lane == 0) sh.warp_counts[warp] = __popc(ballot);
  __syncthreads();  // every slot of the tile has been read
  int64_t before = 0, aggregate = 0;
  for (int w = 0; w < kWarps; ++w) {
    aggregate += sh.warp_counts[w];
    if (w < warp) before += sh.warp_counts[w];
  }
  // Warp 1 publishes the tile's aggregate (tile 0 its inclusive prefix)
  // while warp 0 looks back, so that neither waits on the other's fence;
  // the inclusive prefix follows the block's barrier, so that no write of
  // the tile waits on its fence.
  if (warp == 1 && lane == 0)
    publish(status + tk.tile, (tk.epoch << kEpochShift) |
                                  (tk.tile > 0 ? kAggregate : kPrefix) |
                                  static_cast<Word>(aggregate));
  if (warp == 0) {
    const int64_t prefix =
        tk.tile > 0 ? look_back(status, tk.tile, tk.epoch) : 0;
    if (lane == 0) {
      sh.prefix = prefix;
      if (tk.tile == static_cast<int>(gridDim.x) - 1) {  // the last ticket
        record[0] = prefix + aggregate;
        record[1] = __ldg(cursor);
      }
    }
  }
  __syncthreads();
  if (warp == 0 && lane == 0 && tk.tile > 0)  // warp 1 has published
    publish(status + tk.tile, (tk.epoch << kEpochShift) | kPrefix |
                                  static_cast<Word>(sh.prefix + aggregate));
  return sh.prefix + before + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads)
    shade_pool_kernel(SceneArgs sc, PassArgs a, PoolArgs q) {
  extern __shared__ Word pool_shared[];
  PoolShared& sh = *reinterpret_cast<PoolShared*>(pool_shared);
  const Ticket tk = take_ticket(sh, q.scan);
  const Slot slot = load_slot(
      a, q, static_cast<int64_t>(tk.tile) * kThreads + threadIdx.x);

  // The shading; the slot's segment and sky are added at the end, so that
  // no store is outstanding when the tile's status is published.
  bool cont = false, miss = false;
  V3 p{}, dir{}, att{};
  int64_t row = 0;
  int segs = 0;
  if (slot.live) {
    row = slot.id - __ldg(q.start_id);
    row = row < 0 ? 0 : (row > q.num_rays - 1 ? q.num_rays - 1 : row);
    segs = q.segments[row];
    const Shaded s = shade_slot(
        sc, slot.o, slot.d, slot.prim, slot.hit,
        static_cast<uint32_t>(__ldg(a.key)),
        static_cast<uint32_t>(__ldg(a.key + 1)),
        static_cast<uint32_t>(slot.id),
        static_cast<uint32_t>(slot.depth + 1), a.t_min);
    miss = !s.hit;
    cont = s.hit && s.ok && slot.depth < a.max_depth;
    p = s.p;
    dir = s.dir;
    att = mul(slot.tp, s.att);
  }
  const int64_t dest = compact_slot(sh, q.scan, tk, cont, q.record,
                                    q.cursor);
  if (slot.live) {
    q.segments[row] = segs + 1;
    if (miss) {
      const V3 add_ = sky(slot.tp, slot.d);
      index_add(q.out + 3 * row, add_.x);
      index_add(q.out + 3 * row + 1, add_.y);
      index_add(q.out + 3 * row + 2, add_.z);
    }
  }
  if (cont) {  // straight to its compacted slot
    store3(q.o, dest, p);
    store3(q.d, dest, dir);
    store3(q.tp, dest, att);
    q.ids[dest] = slot.id;
    q.depth[dest] = slot.depth + 1;
    q.alive[dest] = 1;
  }
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
  if (i >= a.n) return;
  // The ray's whole carry and closest hit, in one step.
  const bool live = q.alive[i] != 0;
#if defined(FRT_K9_ALIVE_FIRST)
  if (!live) return;
#endif
  const V3 o = state3(q.origin, i), d = state3(q.direction, i);
  const V3 tp = state3(q.throughput, i);
  const int64_t id = __ldg(q.ray_ids + i);
  const int prim = __ldg(a.prim + i);
  const bool hit_in = __ldg(a.hit + i) != 0;
  const int segs = q.segments[i];
  if (!live) return;  // a dead ray's carry stays
  const int64_t depth = __ldg(q.depth);
  const Shaded s = shade_slot(
      sc, o, d, prim, hit_in, static_cast<uint32_t>(__ldg(a.key)),
      static_cast<uint32_t>(__ldg(a.key + 1)), static_cast<uint32_t>(id),
      static_cast<uint32_t>(depth + 1), a.t_min);
  q.segments[i] = segs + 1;
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

// K10.  The pool's state, whose tail it writes, K9's pass record, the
// camera and the stream's cursor.
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
  const int64_t* record;    // (2,): n_alive, the cursor K9 found
  const int64_t* start_id;  // 0-d
  int64_t* cursor;          // 0-d, written
  int64_t num_rays;
  int64_t n;  // slots
};

__global__ void __launch_bounds__(kThreads)
    regenerate_kernel(RegenArgs a) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_alive = __ldg(a.record);
  const int64_t cursor = __ldg(a.record + 1);
  if (g == 0) {
    const int64_t left = a.num_rays - cursor;
    const int64_t room = a.n - n_alive;
    *a.cursor = cursor + (room < (left < 0 ? 0 : left)
                              ? room
                              : (left < 0 ? 0 : left));
  }
  const int64_t s = n_alive + g;
  if (s >= a.n) return;  // a survivor's slot, or past the pool
  const int64_t fresh = cursor + g;
  const int64_t idx =
      fresh < 0 ? 0 : (fresh > a.num_rays - 1 ? a.num_rays - 1 : fresh);
  const int64_t id = __ldg(a.start_id) + idx;
  const int64_t cam_id =
      id < 0 ? 0 : (id > a.image_rays - 1 ? a.image_rays - 1 : id);
  float o[3], d[3];
  frt::torch_camera_ray<float>(static_cast<uint32_t>(__ldg(a.key)),
                               static_cast<uint32_t>(__ldg(a.key + 1)),
                               cam_id, a.nx, a.ny, a.spp, a.cam, o, d);
  store3(a.o, s, V3{o[0], o[1], o[2]});
  store3(a.d, s, V3{d[0], d[1], d[2]});
  store3(a.tp, s, V3{1.0f, 1.0f, 1.0f});
  a.depth[s] = 0;
  a.ids[s] = id;
  a.alive[s] = fresh < a.num_rays;
}

// K12, lockstep and length modes (record_step_kernel): the recorders' state
// (diff/replay.py::record_state): the rays o, dr (n, 3) and alive (n,) bool,
// updated in place, the ray ids (n,) int64, the bounce counter d (0-d int64)
// and the launch's arrival word (0-d, zero between launches); the tape
// (max_depth + 2, n) int32 whose row min(d, max_depth + 1) the launch writes
// whole, or null; the lengths (n,) int64, or null.
struct StepArgs {
  float* o;
  float* dr;
  uint8_t* alive;
  const int64_t* ray_ids;
  int64_t* d;      // 0-d, advanced by the launch's last block
  Word* arrivals;  // 0-d
  int* tape;
  int64_t* length;
};

// A block's window: kStepWindow consecutive rays, their liveness read four
// bytes a thread by the first kStepWords threads, the live ones packed in
// order and shaded by kStepThreads threads, at most kStepRays each
// (probes/k12_grid.py: one a thread in windows of 256 was the fastest all
// live, and no window or rays a thread moved the sum over the direct
// step's bounces past the spread between calls).
constexpr int kStepWindow = 256;
constexpr int kStepRays = 1;
constexpr int kStepThreads = kStepWindow / kStepRays;
constexpr int kStepWords = kStepWindow / 4;
constexpr int kWordWarps = (kStepWords + 31) / 32;
constexpr int kWarpRays = 4 * 32;  // the rays of a warp's words
static_assert(kStepWords <= kStepThreads, "a thread reads at most a word");
static_assert(kStepRays == 1 || kStepRays == 2, "one or two rays a thread");

// A block's shared memory in lockstep and length modes (dynamic, so that
// the host emulation gives each block its own).
struct StepShared {
  int64_t d;                  // the bounce counter as the launch found it
  int warp_live[kWordWarps];  // the live rays of each warp's words
  int list[kStepWindow];      // warp w's live rays' places, in order, from
                              // w kWarpRays on
};

__device__ __forceinline__ int64_t read_counter(const int64_t* p) {
  return *reinterpret_cast<const volatile int64_t*>(p);
}

// A block's arrival on the launch's arrival word, with acquire and release
// semantics at the scope of the device (so the block's read of the counter
// before it is ordered before every later arrival, and the last block's
// write of the counter after every earlier one); returns the blocks that
// arrived before it.
__device__ __forceinline__ Word arrive(Word* p) {
#if defined(__CUDA_ARCH__)
  Word old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(p)
               : "memory");
  return old;
#else
  return atomicAdd(p, 1ull);
#endif
}

// The place in the window of the live ray at entry e of the packed list:
// the warps' segments in order.
__device__ __forceinline__ int packed(const StepShared& sh, int e) {
  int w = 0;
  for (; w < kWordWarps - 1 && e >= sh.warp_live[w]; ++w)
    e -= sh.warp_live[w];
  return sh.list[w * kWarpRays + e];
}

// Chains 0 .. K - 1 of this thread: the live rays at list entries
// threadIdx.x + k kStepThreads, each clamped to the last live entry (so
// that every chain runs and the compiler may interleave them) and written
// only when it is live.  Below the depth cap a ray is shaded at bounce d
// (+1 for the draw's domain) from its state and closest hit, read here and
// nowhere else; at or past it, it only ends.  A ray's length counts the
// bounce, its tape entry (in the row the launch writes) is the winner
// where the recompute hit, and it goes on with its next o, dr if it hit,
// scattered and is within the cap.
template <int K>
__device__ __forceinline__ void shade_rays(const SceneArgs& sc,
                                           const PassArgs& a,
                                           const StepArgs& q,
                                           const StepShared& sh,
                                           int64_t base, int live,
                                           int64_t d, int* row) {
  int e[K];
  int64_t i[K];
  V3 o[K], dr[K];
  int64_t id[K];
  int prim[K];
  bool hit_in[K];
  const bool shade = d <= a.max_depth;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = threadIdx.x + k * kStepThreads;
    i[k] = base + packed(sh, e[k] < live ? e[k] : live - 1);
    if (shade) {
      o[k] = state3(q.o, i[k]);
      dr[k] = state3(q.dr, i[k]);
      id[k] = __ldg(q.ray_ids + i[k]);
      prim[k] = __ldg(a.prim + i[k]);
      hit_in[k] = __ldg(a.hit + i[k]) != 0;
    }
  }
  const uint32_t k0 = static_cast<uint32_t>(__ldg(a.key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(a.key + 1));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int entry = -1;
    bool cont = false;
    Shaded s{};
    if (shade) {
      s = shade_slot(sc, o[k], dr[k], prim[k], hit_in[k], k0, k1,
                     static_cast<uint32_t>(id[k]),
                     static_cast<uint32_t>(d + 1), a.t_min);
      if (s.hit) entry = prim[k];
      cont = s.hit && s.ok && d < a.max_depth;
    }
    if (e[k] >= live) continue;
    if (q.length) q.length[i[k]] += 1;  // entered this bounce alive
    if (cont) {
      store3(q.o, i[k], s.p);
      store3(q.dr, i[k], s.dir);
    }
    q.alive[i[k]] = cont;
    if (row) row[i[k]] = entry;
  }
}

__global__ void __launch_bounds__(kStepThreads)
    record_step_kernel(SceneArgs sc, PassArgs a, StepArgs q) {
  extern __shared__ Word step_shared[];
  StepShared& sh = *reinterpret_cast<StepShared*>(step_shared);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kStepWindow;

  // The window's liveness, four rays a word, and (thread 0) the counter,
  // both in flight at once.
  unsigned m = 0;
  const int64_t i4 = base + 4 * t;  // the first ray of this thread's word
  const bool whole = i4 + 4 <= a.n;
  if (t < kStepWords) {
    if (whole && (reinterpret_cast<uintptr_t>(q.alive + i4) & 3) == 0) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(q.alive + i4);
      for (int j = 0; j < 4; ++j) m |= ((w >> (8 * j)) & 0xffu ? 1u : 0u) << j;
    } else {
      for (int j = 0; j < 4; ++j)
        if (i4 + j < a.n && q.alive[i4 + j] != 0) m |= 1u << j;
    }
  }
  int64_t d = 0;
  if (t == 0) d = read_counter(q.d);

  // The live rays packed in order, each warp's into its own segment: the
  // ballots of a word's four bytes give a lane its rank in its warp.  One
  // barrier; the warps' counts then give an entry's segment (packed).
  const unsigned below = (1u << lane) - 1u;
  int rank = 0, count = 0;
  for (int j = 0; j < 4; ++j) {
    const unsigned b = __ballot_sync(kFullMask, (m >> j) & 1u);
    rank += __popc(b & below);
    count += __popc(b);
  }
  if (t < kStepWords) {
    for (int j = 0; j < 4; ++j)
      if ((m >> j) & 1u) sh.list[warp * kWarpRays + rank++] = 4 * t + j;
    if (lane == 0) sh.warp_live[warp] = count;
  }
  // The block arrives once it has read the counter; the last block to
  // arrive advances it and clears the arrival word for the next launch, at
  // the end, where the arrival's answer is first waited for.  Every block
  // read d before it arrived, so none reads a moved counter.
  Word arrived = 0;
  if (t == 0) {
    sh.d = d;
    arrived = arrive(q.arrivals);
  }
  __syncthreads();
  int live = 0;
  for (int w = 0; w < kWordWarps; ++w) live += sh.warp_live[w];
  d = sh.d;

  // The tape's row: a dead ray's -1 from the thread that read its
  // liveness (a word of four in one 16-byte store where the row is
  // aligned), a live ray's entry from the thread that shades it.
  int* row = nullptr;
  if (q.tape) {
    row = q.tape + (d < a.max_depth + 1 ? d : a.max_depth + 1) * a.n;
    if (t < kStepWords) {
      int* dst = row + i4;
      if (m == 0 && whole && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<int4*>(dst) = make_int4(-1, -1, -1, -1);
      } else {
        for (int j = 0; j < 4; ++j)
          if (!((m >> j) & 1u) && i4 + j < a.n) dst[j] = -1;
      }
    }
  }

  // The live rays in full warps: a warp runs the chains that hold a live
  // entry of its lanes.
  if (kStepRays == 2 && warp * 32 + kStepThreads < live)
    shade_rays<kStepRays>(sc, a, q, sh, base, live, d, row);
  else if (warp * 32 < live)
    shade_rays<1>(sc, a, q, sh, base, live, d, row);

  if (t == 0 && arrived == gridDim.x - 1) {
    *q.arrivals = 0;
    *reinterpret_cast<volatile int64_t*>(q.d) = d + 1;
  }
}

// K12, pool mode with K13 folded in (record_pool_kernel): the pool
// recorder's state (diff/replay.py::record_pool_state): o, d (C, 3), ids,
// col, depth (C,) int64 and alive (C,) bool, compacted and refilled in
// place; the flat tape (D * R + 1,) int32 of the stream's R rays (ray_ids
// (R,) int64), D = max_depth + 1; the cursor (read and advanced), the pass
// record (written) and the scan's ticket and status words; the camera
// and image size of the tail's camera rays.
struct RecordPoolArgs {
  float* o;
  float* d;
  int64_t* ids;
  int64_t* col;
  int64_t* depth;
  uint8_t* alive;
  int* tape;
  const int64_t* ray_ids;  // (R,)
  int64_t num_rays;        // R
  int64_t* cursor;         // 0-d
  int64_t* record;         // (2,)
  Word* scan;              // (1 + tiles,)
  CameraFields<float> cam;
  int64_t nx, ny, spp;
};

// Slots a tile of the pool mode's scan, a thread each (probes/k12_grid.py).
constexpr int kRecordTile = 256;
constexpr int kRecordWarps = kRecordTile / 32;

// A block's shared memory in pool mode.
struct RecordShared {
  Word ticket;
  int64_t prefix;   // the tile's exclusive prefix
  int64_t n_alive;  // the pass's survivors
  int64_t cursor;   // the cursor as the pass found it
  int warp_counts[kRecordWarps];
};

// The persistent loop's ticket, beside take_ticket: a pass hands out one
// ticket a tile and then one a block, which finds the tiles gone (its tile
// is -1); so a pass takes tiles + gridDim.x tickets and the epoch is the
// ticket over that.
__device__ __forceinline__ Ticket take_tile(Word& slot, Word* scan,
                                            int tiles) {
  if (threadIdx.x == 0) slot = atomicAdd(scan, 1ull);
  __syncthreads();
  const Word per_pass = static_cast<Word>(tiles) + gridDim.x;
  const Word local = slot % per_pass;
  return Ticket{local < static_cast<Word>(tiles) ? static_cast<int>(local)
                                                 : -1,
                (slot / per_pass) & kEpochMask};
}

// compact_slot for the pool recorder's tiles: the same scan, but the last
// tile (tiles - 1) writes the pass record (n_alive, the cursor as the pass
// found it) before it publishes its inclusive prefix, whose release the
// other blocks wait on; then it advances the cursor, which no other block
// reads.  Tile 0 publishes its inclusive prefix at once unless it is the
// last.
__device__ __forceinline__ int64_t compact_tile(RecordShared& sh,
                                                const RecordPoolArgs& q,
                                                Ticket tk, int tiles,
                                                int64_t n, bool cont) {
  Word* status = q.scan + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool last = tk.tile == tiles - 1;
  const unsigned ballot = __ballot_sync(kFullMask, cont);
  if (lane == 0) sh.warp_counts[warp] = __popc(ballot);
  __syncthreads();  // every slot of the tile has been read
  int64_t before = 0, aggregate = 0;
  for (int w = 0; w < kRecordWarps; ++w) {
    aggregate += sh.warp_counts[w];
    if (w < warp) before += sh.warp_counts[w];
  }
  if (warp == 1 && lane == 0 && (tk.tile > 0 || !last))
    publish(status + tk.tile, (tk.epoch << kEpochShift) |
                                  (tk.tile > 0 ? kAggregate : kPrefix) |
                                  static_cast<Word>(aggregate));
  int64_t found = 0;  // the cursor (lane 0 of warp 0 of the last tile)
  if (warp == 0) {
    const int64_t prefix =
        tk.tile > 0 ? look_back(status, tk.tile, tk.epoch) : 0;
    if (lane == 0) {
      sh.prefix = prefix;
      if (last) {
        found = read_counter(q.cursor);
        q.record[0] = prefix + aggregate;
        q.record[1] = found;
      }
    }
  }
  __syncthreads();
  if (warp == 0 && lane == 0 && (tk.tile > 0 || last)) {
    const int64_t n_alive = sh.prefix + aggregate;
    publish(status + tk.tile,
            (tk.epoch << kEpochShift) | kPrefix | static_cast<Word>(n_alive));
    if (last) {
      const int64_t left = q.num_rays - found;
      const int64_t room = n - n_alive;
      *q.cursor = found + (room < (left < 0 ? 0 : left)
                               ? room
                               : (left < 0 ? 0 : left));
    }
  }
  return sh.prefix + before + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kRecordTile)
    record_pool_kernel(SceneArgs sc, PassArgs a, RecordPoolArgs q) {
  extern __shared__ Word record_shared[];
  RecordShared& sh = *reinterpret_cast<RecordShared*>(record_shared);
  const int tiles = static_cast<int>((a.n + kRecordTile - 1) / kRecordTile);
  const uint32_t k0 = static_cast<uint32_t>(__ldg(a.key));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(a.key + 1));
  Word epoch = 0;
  for (;;) {
    const Ticket tk = take_tile(sh.ticket, q.scan, tiles);
    epoch = tk.epoch;
    if (tk.tile < 0) break;
    const int64_t i = static_cast<int64_t>(tk.tile) * kRecordTile +
                      threadIdx.x;
    // The slot's state and closest hit, in one step.
    bool live = false, hit_in = false;
    V3 o{}, d{};
    int64_t id = 0, col = 0, depth = 0;
    int prim = 0;
    if (i < a.n) {
      live = q.alive[i] != 0;
      o = state3(q.o, i);
      d = state3(q.d, i);
      id = q.ids[i];
      col = q.col[i];
      depth = q.depth[i];
      prim = __ldg(a.prim + i);
      hit_in = __ldg(a.hit + i) != 0;
    }
    bool write = false, cont = false;
    V3 p{}, dir{};
    if (live) {
      const Shaded s = shade_slot(sc, o, d, prim, hit_in, k0, k1,
                                  static_cast<uint32_t>(id),
                                  static_cast<uint32_t>(depth + 1), a.t_min);
      write = s.hit;
      cont = s.hit && s.ok && depth < a.max_depth;
      p = s.p;
      dir = s.dir;
    }
    const int64_t dest = compact_tile(sh, q, tk, tiles, a.n, cont);
    // The hit's tape entry (live slots hold distinct columns); a depth past
    // the tape's rows, which the recorder never gives, writes nothing.
    if (write && depth >= 0 && depth <= a.max_depth)
      q.tape[depth * q.num_rays + col] = prim;
    if (cont) {  // straight to its compacted slot
      store3(q.o, dest, p);
      store3(q.d, dest, dir);
      q.ids[dest] = id;
      q.col[dest] = col;
      q.depth[dest] = depth + 1;
      q.alive[dest] = 1;
    }
  }

  // K13: the tail [n_alive, C), once the last tile's inclusive prefix (the
  // pass's n_alive) is published, and the pass record with it; block b
  // refills tail slots b kRecordTile + threadIdx.x, a grid's threads apart.
  if (threadIdx.x == 0) {
    const Word* status = q.scan + tiles;  // the last tile's word
    Word w;
    for (;;) {
      w = peek(status);
      if ((w >> kEpochShift) == epoch && (w & kFlagMask) == kPrefix) break;
      __nanosleep(32);
    }
    __threadfence();  // the read above becomes an acquire read
    sh.n_alive = static_cast<int64_t>(w & kCountMask);
    sh.cursor = read_counter(q.record + 1);
  }
  __syncthreads();
  const int64_t n_alive = sh.n_alive, cursor = sh.cursor;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRecordTile;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kRecordTile +
                   threadIdx.x;
       n_alive + g < a.n; g += stride) {
    const int64_t s = n_alive + g;
    const int64_t fresh = cursor + g;
    const int64_t idx =
        fresh < 0 ? 0 : (fresh > q.num_rays - 1 ? q.num_rays - 1 : fresh);
    const int64_t id = __ldg(q.ray_ids + idx);
    float ro[3], rd[3];
    frt::torch_camera_ray<float>(k0, k1, id, q.nx, q.ny, q.spp, q.cam, ro,
                                 rd);
    store3(q.o, s, V3{ro[0], ro[1], ro[2]});
    store3(q.d, s, V3{rd[0], rd[1], rd[2]});
    q.ids[s] = id;
    q.col[s] = idx;
    q.depth[s] = 0;
    q.alive[s] = fresh < q.num_rays;
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

// Launches K9 in pool mode on `stream` over n slots (module comment): the
// scene, sph_center (ns, 3), sph_radius (ns,), sph_mat (ns,) int32,
// tri_v0, tri_v1, tri_v2 (nt, 3), tri_mat (nt,) int32, and the material
// table of nm rows: mat_type, tex_type (int32), albedo, albedo2 (nm, 3),
// tex_scale, fuzz, ref_idx; the pool's state, compacted in place; the
// closest hit; the output rows and segments; the cursor (0-d int64, read),
// the pass record (2,) int64 (written) and the scan's words (1 + one a
// block of kThreads slots, uint64; zeroed once when the pool is made, then
// left to the kernel).  Launches nothing for n = 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
int frt_shade_pool(const int64_t* key, const float* sph_center,
                   const float* sph_radius, const int* sph_mat,
                   const float* tri_v0, const float* tri_v1,
                   const float* tri_v2, const int* tri_mat, int ns, int nt,
                   const int* mat_type, const int* tex_type,
                   const float* albedo, const float* albedo2,
                   const float* tex_scale, const float* fuzz,
                   const float* ref_idx, int nm, float* o, float* d,
                   float* tp, int64_t* ids, int64_t* depth, uint8_t* alive,
                   const int* prim, const uint8_t* hit,
                   const int64_t* start_id, int64_t num_rays, int max_depth,
                   float t_min, float* out, int* segments,
                   const int64_t* cursor, int64_t* record, Word* scan,
                   int64_t n, void* stream) {
  if (n > 0) {
    const SceneArgs sc = scene_args(sph_center, sph_radius, sph_mat, tri_v0,
                                    tri_v1, tri_v2, tri_mat, ns, nt,
                                    mat_type, tex_type, albedo, albedo2,
                                    tex_scale, fuzz, ref_idx, nm);
    const PassArgs a{key, prim, hit, n, max_depth, t_min};
    const PoolArgs q{o,   d,        tp,     ids,    depth,
                     alive, start_id, num_rays, out, segments,
                     cursor, record, scan};
    shade_pool_kernel<<<blocks_for(n), kThreads, sizeof(PoolShared),
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
// (its tail written), K9's pass record (2,) int64, the first id (0-d
// int64), the cursor (0-d int64, written) and the stream's length
// num_rays.  Launches nothing for n = 0.
int frt_regenerate(const int64_t* key, const float* cam_origin,
                   const float* cam_lower_left, const float* cam_horizontal,
                   const float* cam_vertical, const float* cam_u,
                   const float* cam_v, const float* cam_lens_radius,
                   int64_t nx, int64_t ny, int64_t spp, float* o, float* d,
                   float* tp, int64_t* ids, int64_t* depth, uint8_t* alive,
                   const int64_t* record, const int64_t* start_id,
                   int64_t* cursor, int64_t num_rays, int64_t n,
                   void* stream) {
  if (n > 0) {
    const CameraFields<float> cam{cam_origin, cam_lower_left, cam_horizontal,
                                  cam_vertical, cam_u,      cam_v,
                                  cam_lens_radius};
    const RegenArgs a{key,   cam,    nx,     ny,       spp,
                      nx * ny * spp, o,      d,        tp,
                      ids,   depth,  alive,  record,   start_id,
                      cursor, num_rays, n};
    regenerate_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K12 in lockstep or length mode on `stream` over n rays (module
// comment): the key, the scene as for K9, the rays o, dr (n, 3) and alive
// (n,) bool, updated in place, the ray ids (n,) int64, the bounce counter
// (0-d int64, advanced by one), the arrival word (0-d int64, zero between
// launches), the closest hit, the tape ((max_depth + 2) x n int32, or
// null) and the lengths ((n,) int64, or null).  Launches one block for
// n = 0, which advances the counter.
int frt_record_step(const int64_t* key, const float* sph_center,
                    const float* sph_radius, const int* sph_mat,
                    const float* tri_v0, const float* tri_v1,
                    const float* tri_v2, const int* tri_mat, int ns, int nt,
                    const int* mat_type, const int* tex_type,
                    const float* albedo, const float* albedo2,
                    const float* tex_scale, const float* fuzz,
                    const float* ref_idx, int nm, float* o, float* dr,
                    uint8_t* alive, const int64_t* ray_ids, int64_t* d,
                    Word* arrivals, const int* prim, const uint8_t* hit,
                    int* tape, int64_t* length, int max_depth, float t_min,
                    int64_t n, void* stream) {
  const SceneArgs sc = scene_args(sph_center, sph_radius, sph_mat, tri_v0,
                                  tri_v1, tri_v2, tri_mat, ns, nt, mat_type,
                                  tex_type, albedo, albedo2, tex_scale, fuzz,
                                  ref_idx, nm);
  const PassArgs a{key, prim, hit, n, max_depth, t_min};
  const StepArgs q{o, dr, alive, ray_ids, d, arrivals, tape, length};
  const int64_t windows = (n + kStepWindow - 1) / kStepWindow;
  const int blocks = static_cast<int>(windows > 0 ? windows : 1);
  record_step_kernel<<<blocks, kStepThreads, sizeof(StepShared),
                       static_cast<cudaStream_t>(stream)>>>(sc, a, q);
  return static_cast<int>(cudaGetLastError());
}

// Launches K12 in pool mode, K13 folded in, on `stream` over the pool's n
// slots (module comment): the key, the scene as for K9, the pool's state
// o, d (n, 3), ids, col, depth (n,) int64, alive (n,) bool, compacted and
// refilled in place; the closest hit; the flat tape ((max_depth + 1) *
// num_rays + 1 int32); the stream's ray ids (num_rays,) int64; the cursor
// (0-d int64, advanced), the pass record (2,) int64 (written) and the
// scan's words (1 + one a tile of kRecordTile slots, uint64; zeroed once
// when the pool is made, then left to the kernel: a pass takes tiles +
// blocks tickets); the camera's seven float32 fields and the image's size
// (nx, ny, spp).  A persistent grid: at most the blocks the card holds at
// once.  Launches nothing for n = 0.
int frt_record_pool(const int64_t* key, const float* sph_center,
                    const float* sph_radius, const int* sph_mat,
                    const float* tri_v0, const float* tri_v1,
                    const float* tri_v2, const int* tri_mat, int ns, int nt,
                    const int* mat_type, const int* tex_type,
                    const float* albedo, const float* albedo2,
                    const float* tex_scale, const float* fuzz,
                    const float* ref_idx, int nm, float* o, float* d,
                    int64_t* ids, int64_t* col, int64_t* depth,
                    uint8_t* alive, const int* prim, const uint8_t* hit,
                    int* tape, const int64_t* ray_ids, int64_t num_rays,
                    int max_depth, float t_min, int64_t* cursor,
                    int64_t* record, Word* scan, const float* cam_origin,
                    const float* cam_lower_left, const float* cam_horizontal,
                    const float* cam_vertical, const float* cam_u,
                    const float* cam_v, const float* cam_lens_radius,
                    int64_t nx, int64_t ny, int64_t spp, int64_t n,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, record_pool_kernel, kRecordTile, sizeof(RecordShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kRecordTile - 1) / kRecordTile;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 1 ? per_sm
                                                                   : 1);
  const SceneArgs sc = scene_args(sph_center, sph_radius, sph_mat, tri_v0,
                                  tri_v1, tri_v2, tri_mat, ns, nt, mat_type,
                                  tex_type, albedo, albedo2, tex_scale, fuzz,
                                  ref_idx, nm);
  const PassArgs a{key, prim, hit, n, max_depth, t_min};
  const CameraFields<float> cam{cam_origin, cam_lower_left, cam_horizontal,
                                cam_vertical, cam_u,      cam_v,
                                cam_lens_radius};
  const RecordPoolArgs q{o,        d,      ids,    col,  depth, alive,
                         tape,     ray_ids, num_rays, cursor, record, scan,
                         cam,      nx,     ny,     spp};
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  record_pool_kernel<<<blocks, kRecordTile, sizeof(RecordShared),
                       static_cast<cudaStream_t>(stream)>>>(sc, a, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
