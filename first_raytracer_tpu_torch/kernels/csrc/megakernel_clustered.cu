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
// The slab test stays conservative (slab.cuh::slab_gate): near and far are
// widened by a few ulp, as the TPU kernel does, so a knife-edge hit is never
// culled; a NaN (an origin on a slab plane with a zero direction component,
// 0 * inf) passes the gate, since no other lane of a tile opens the cluster
// for this ray here.
//
// K3 (`mega_clustered_kernel`) renders with K1's persistent warps and their
// regeneration (mega_common.cuh::render_warp) and writes each pixel's
// radiance sum, segment count and sweep counters.  K3t
// (`record_clustered_kernel`) records with K2b's persistent warps
// (mega_common.cuh::record_warp), whose lanes take the next unstarted ray
// id of their warp's window as their paths end: an int32 (D, R) tape
// holding -1 or the original id, every row written, and per-ray trip counts
// and sweep counters.  At 2^17 rays, about the card's resident lanes, a K3t
// launch ends on a chain: the segments of its few deepest paths (rays
// trapped to the depth cap; several often share a warp: walking a warp's
// lone live ray alone did not shorten the launch, walking up to four did),
// each segment testing up to 40 gate boxes in order on one lane while the
// rest idle.  So a K3t warp with at most 4 live lanes walks their gates
// together (ClusterScene::walk): each ray's box intervals are taken 32 / k
// boxes at a time by its share of the lanes, and a ballot finds the next
// box any ray passes, with the same bounds in the same order, so the same
// clusters open and the counters count the same tests; a deep path's
// segment alone went from 5.6 to 4.6 us on field5000 and from 9.0 to 4.9
// on field20000.
//
// The TPU schedule is not carried over: no band, stride or rect pixel
// mapping, no flush blocks, no gate words, ctz loop or two rounds, no one-hot
// extraction of the winner's payload, no float-reciprocal division, no id + 1
// float tape or VMEM spp batches.
//
// What bounds it on an H100, and what this design does about it: FP32 work
// in the sweeps actually run (20 operations per sphere slot and 46 per
// triangle slot tested) and in the box tests, and, with one thread per
// pixel and per-lane loops (the first design), the union of a warp's gated
// clusters, each swept by the few lanes that opened it while the rest
// waited.  Here every segment step of a warp is one sweep that the whole
// warp runs together (ClusterScene::closest):
//  - the gate tables (supergroup boxes, cluster boxes, member counts and
//    supergroup starts) are staged once per block in shared memory
//    (field20000's spheres take 6.4 KB); a scene whose tables pass
//    kGateCap reads them from device memory;
//  - for each supergroup, in a loop the warp runs in step, every lane
//    gates the supergroup and its clusters against its own running best t,
//    and the warp ballots the lanes each cluster opened;
//  - an opened cluster's member rows are copied once into the warp's
//    shared buffer (cp.async; 128 x 16 B for spheres, 9 planes x 128
//    floats for triangles), and its (ray, cluster) pairs are split over the
//    warp's lanes: with k lanes needing the cluster, S = 32 / k lanes
//    (rounded down to a power of two, at most kMaxSplit) take each pair,
//    each a stride of its members, the spheres in groups of four sharing
//    one branch to the root, and the S partial winners meet in a
//    warp-shuffle lexicographic minimum;
//  - the winner of each type stays the lexicographic minimum of (t,
//    column), a sphere winning a sphere/triangle tie, so neither the split
//    nor the order in which gates fire changes it.
// The counters keep the per-lane numbers (clusters opened, slots and boxes
// tested) and add the warp's: the clusters its sweeps opened, each once
// however many lanes needed it, and its segment steps.
#include "mega_common.cuh"
#include "slab.cuh"

namespace {

using frt::CameraRow;
using frt::commit_copies;
using frt::copy16_async;
using frt::fold_lex;
using frt::Hit;
using frt::kBig;
using frt::kFullMask;
using frt::kWarpSize;
using frt::nth_lane;
using frt::PathParams;
using frt::RecordLaunch;
using frt::RenderLaunch;
using frt::round4;
using frt::slab_gate;
using frt::slab_interval;
using frt::slab_pass;
using frt::Surface;
using frt::wait_copies;

constexpr int kThreads = frt::kRenderThreads;
constexpr int kSlots = 128;  // columns per cluster
// The most lanes that share one (ray, cluster) pair; 1 sweeps each pair
// on the lane of its ray.
constexpr int kMaxSplit = 32;
// The fewest lanes a ray's gates take in pass_split: with k live lanes K3t's
// warp walks the gates of each ray over 32 / k lanes when that is at least
// this many (k <= 4), else each lane gates its own ray.  8: at 2^17 rays
// 0.455 / 0.568 ms (field5000 / field20000) against 0.48 / 0.59 at 4 and
// 0.50 / 0.72 never walking (probes/mega_grid.py, PERF.md).
constexpr int kMinWalkSplit = 8;
// Bytes of one type's gate tables a block stages in shared memory.
constexpr int kGateCap = 16 * 1024;
// Samples of a pixel per unit of work.  2: a warp's window then holds the
// two halves of one group's samples more often than two groups, and its
// lanes' rays stay closer together, so the clusters they open overlap
// more (trifield20000 1.97 ms against 2.24 at 4; probes/mega_grid.py).
constexpr int kMaxChunk = 2;

// What a lane's sweeps did (kLane counters, summed per pixel or ray), and
// what its warp's did.
struct ClusterCounters {
  static constexpr int kLane = 4;
  int clusters = 0;   // clusters opened (spheres and triangles)
  int sph_slots = 0;  // sphere slots tested
  int tri_slots = 0;  // triangle slots tested
  int boxes = 0;      // supergroup and cluster boxes slab-tested
  int warp_clusters = 0;  // clusters the warp swept, each once

  // Adds the lane's counts to `dst` (shared memory) and clears them.
  __device__ __forceinline__ void flush(int* dst) {
    atomicAdd(dst + 0, clusters);
    atomicAdd(dst + 1, sph_slots);
    atomicAdd(dst + 2, tri_slots);
    atomicAdd(dst + 3, boxes);
    clusters = sph_slots = tri_slots = boxes = 0;
  }
  // Writes the lane's counts to `dst` and clears them.
  __device__ __forceinline__ void store(int* dst) {
    dst[0] = clusters;
    dst[1] = sph_slots;
    dst[2] = tri_slots;
    dst[3] = boxes;
    clusters = sph_slots = tri_slots = boxes = 0;
  }
};

// One primitive type's gate tables: supergroup boxes (ks, 2) float4,
// cluster boxes (kc, 2) float4, member counts (kc,), supergroup starts
// (ks + 1,): in shared memory once staged, else in device memory.
struct GateTables {
  const float4* supers;
  const float4* boxes;
  const int* counts;
  const int* starts;
  int ks, kc;

  __host__ __device__ static constexpr int bytes(int ks, int kc) {
    return 32 * ks + 32 * kc + 4 * round4(kc) + 4 * round4(ks + 1);
  }
  __host__ __device__ static constexpr int staged_bytes(int ks, int kc,
                                                        bool present) {
    return present && bytes(ks, kc) <= kGateCap ? bytes(ks, kc) : 0;
  }

  // The block copies the tables to `smem` (staged_bytes of them); the
  // caller syncs.
  __device__ void stage(unsigned char* smem) {
    float4* sup = reinterpret_cast<float4*>(smem);
    float4* box = sup + 2 * ks;
    int* cnt = reinterpret_cast<int*>(box + 2 * kc);
    int* st = cnt + round4(kc);
    for (int q = threadIdx.x; q < 2 * ks; q += blockDim.x)
      copy16_async(sup + q, supers + q);
    for (int q = threadIdx.x; q < 2 * kc; q += blockDim.x)
      copy16_async(box + q, boxes + q);
    for (int q = threadIdx.x; q < kc; q += blockDim.x) cnt[q] = counts[q];
    for (int q = threadIdx.x; q <= ks; q += blockDim.x) st[q] = starts[q];
    supers = sup;
    boxes = box;
    counts = cnt;
    starts = st;
  }
};

// The clustered scene (kernels/megakernel_clustered.py::MegaClusteredPack).
//   sph (16, sp): 0-2 center, 3 radius, 4 param, 5-7 albedo, 8-10 albedo2,
//       11 tex_scale, 12 original id, 13 material type, 14 texture type,
//       15 1/radius;
//   mx (sp, 8): cx cy cz c0 (unused here), cx cy cz r (the sphere root's
//       row; r NaN in sentinel slots);
//   tri (24, tp): the dense rows 0-20, 21 material type, 22 texture type;
//   boxes (K, 8) and super boxes (KS, 8): mnx mny mnz mxx mxy mxz pad pad;
//   starts (KS + 1,): first cluster of each supergroup, then K;
//   counts (K,): members of each cluster, which fill its first columns.
struct ClusterScene {
  const float* sph;
  const float4* mx;
  const float* tri;
  GateTables sg, tg;
  int ns, nt, sp, tp;
  float* members = nullptr;  // this warp's buffer of member rows
  using Counters = ClusterCounters;

  // Bytes of a warp's member buffer: 128 sphere rows, or the 9 planes of
  // 128 triangles.
  __host__ __device__ static constexpr int member_bytes(int ns, int nt) {
    return (nt > 0 ? 4 * 9 * kSlots : 0) > (ns > 0 ? 16 * kSlots : 0)
               ? 4 * 9 * kSlots
               : (ns > 0 ? 16 * kSlots : 0);
  }
  __host__ __device__ static constexpr int smem_bytes(int ns, int nt, int ks,
                                                      int kc, int kts,
                                                      int kt) {
    return GateTables::staged_bytes(ks, kc, ns > 0) +
           GateTables::staged_bytes(kts, kt, nt > 0) +
           frt::kRenderWarps * member_bytes(ns, nt);
  }

  // Every thread of the block calls this once: the gate tables that fit go
  // to shared memory, and each warp gets its member buffer.
  __device__ void stage(unsigned char* smem) {
    unsigned char* p = smem;
    const int bs = GateTables::staged_bytes(sg.ks, sg.kc, ns > 0);
    if (bs > 0) sg.stage(p);
    p += bs;
    const int bt = GateTables::staged_bytes(tg.ks, tg.kc, nt > 0);
    if (bt > 0) tg.stage(p);
    p += bt;
    members = reinterpret_cast<float*>(
        p + (threadIdx.x / kWarpSize) * member_bytes(ns, nt));
    commit_copies();
    wait_copies<0>();
    __syncthreads();
  }

  // Copies cluster c's member rows to the warp's buffer (whole warp).
  template <bool TRI>
  __device__ __forceinline__ void load_members(int c, int m) const {
    const int lane = threadIdx.x % kWarpSize;
    const size_t col0 = static_cast<size_t>(c) * kSlots;
    __syncwarp();  // every lane is done with the last cluster's rows
    if (TRI) {
      const int runs = round4(m) / 4;  // within the cluster's 128 columns
      for (int q = lane; q < 9 * runs; q += kWarpSize) {
        const int pl = q / runs, k = 4 * (q % runs);
        copy16_async(members + pl * kSlots + k,
                     tri + static_cast<size_t>(pl) * tp + col0 + k);
      }
    } else {
      float4* rows = reinterpret_cast<float4*>(members);
      for (int j = lane; j < round4(m); j += kWarpSize)
        copy16_async(rows + j, mx + 2 * (col0 + j) + 1);
    }
    commit_copies();
    wait_copies<0>();
    __syncwarp();
  }

  // The members of cluster c (m of them, in the warp's buffer) against the
  // rays of the lanes in `need`, split over the warp; `need_me` says
  // whether this lane's ray is one of them, and its (t_best, w_best) takes
  // the cluster's winner.
  template <bool TRI>
  __device__ __forceinline__ void sweep(int c, int m, unsigned need,
                                        bool need_me, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float t_min, float& t_best,
                                        int& w_best) const {
    const int lane = threadIdx.x % kWarpSize;
    const int k = __popc(need);
    const int split = frt::lanes_per_ray(k, kMaxSplit);  // lanes per pair
    const int g = lane / split, sub = lane % split;
    // Lane g * split + sub takes pair g: the ray of the g-th lane in need.
    const int src = g < k ? nth_lane(need, g) : lane;
    float rox = ox, roy = oy, roz = oz, rdx = dx, rdy = dy, rdz = dz;
    if (split > 1) {
      rox = __shfl_sync(kFullMask, ox, src);
      roy = __shfl_sync(kFullMask, oy, src);
      roz = __shfl_sync(kFullMask, oz, src);
      rdx = __shfl_sync(kFullMask, dx, src);
      rdy = __shfl_sync(kFullMask, dy, src);
      rdz = __shfl_sync(kFullMask, dz, src);
    }
    const bool mine = split > 1 ? g < k : need_me;
    const int col0 = c * kSlots;
    float t_c = kBig;
    int w_c = INT_MAX;
    if (mine) {
      auto fold = [&](float t, int w) {
        if (t < kBig) fold_lex(t, w, t_c, w_c);
      };
      const int first = split > 1 ? sub : 0;
      if (TRI) {
        const float* pl = members;
        for (int j = first; j < m; j += split) {
          float t;
          if (frt::triangle_hit(pl[j], pl[kSlots + j], pl[2 * kSlots + j],
                                pl[3 * kSlots + j], pl[4 * kSlots + j],
                                pl[5 * kSlots + j], pl[6 * kSlots + j],
                                pl[7 * kSlots + j], pl[8 * kSlots + j], rox,
                                roy, roz, rdx, rdy, rdz, t_min, t))
            fold(t, col0 + j);
        }
      } else {
        const float slack = frt::sphere_slack(rdx, rdy, rdz);
        const float4* rows = reinterpret_cast<const float4*>(members);
        // Whole groups: the pack's empty slots are never-hit sentinels.
        for (int j = frt::kGroup * first; j < m;
             j += frt::kGroup * split) {
          const float4 s[frt::kGroup] = {rows[j], rows[j + 1], rows[j + 2],
                                         rows[j + 3]};
          frt::sphere_group(s, rox, roy, roz, rdx, rdy, rdz, slack, t_min,
                            col0 + j, fold);
        }
      }
    }
    if (split > 1) {
      for (int o = 1; o < split; o <<= 1) {  // the pair's S partial winners
        const float t = __shfl_xor_sync(kFullMask, t_c, o);
        const int w = __shfl_xor_sync(kFullMask, w_c, o);
        fold_lex(t, w, t_c, w_c);
      }
      // Each lane in need takes its pair's result from the pair's first
      // lane: its rank among the lanes in need, times the split.
      const int rank = __popc(need & ((1u << lane) - 1u));
      const int from = need_me ? rank * split : lane;
      const float t = __shfl_sync(kFullMask, t_c, from);
      const int w = __shfl_sync(kFullMask, w_c, from);
      t_c = t;
      w_c = w;
    }
    if (need_me && t_c < kBig) fold_lex(t_c, w_c, t_best, w_best);
  }

  // One type's two-level gated sweep; the whole warp calls it.
  template <bool TRI>
  __device__ __forceinline__ void pass(const GateTables& gt, float ox,
                                       float oy, float oz, float dx,
                                       float dy, float dz, float ivx,
                                       float ivy, float ivz, float t_min,
                                       bool active, float other,
                                       float& t_best, int& w_best,
                                       Counters& cnt) const {
    for (int s = 0; s < gt.ks; ++s) {
      const float bound0 = fminf(t_best, other);
      bool pass_s = false;
      if (active) {
        ++cnt.boxes;
        pass_s = slab_gate(gt.supers[2 * s], gt.supers[2 * s + 1], ox, oy, oz,
                           ivx, ivy, ivz, t_min, bound0);
      }
      if (!__any_sync(kFullMask, pass_s)) continue;
      const int c0 = gt.starts[s], c1 = gt.starts[s + 1];
      for (int c = c0; c < c1; ++c) {
        bool need_me = pass_s;
        if (pass_s && c1 - c0 > 1) {
          ++cnt.boxes;
          need_me = slab_gate(gt.boxes[2 * c], gt.boxes[2 * c + 1], ox, oy,
                              oz, ivx, ivy, ivz, t_min,
                              fminf(t_best, other));
        }
        const unsigned need = __ballot_sync(kFullMask, need_me);
        if (need == 0u) continue;
        const int m = gt.counts[c];
        if (need_me) {
          ++cnt.clusters;
          if (TRI)
            cnt.tri_slots += m;
          else
            cnt.sph_slots += m;
        }
        ++cnt.warp_clusters;
        load_members<TRI>(c, m);
        sweep<TRI>(c, m, need, need_me, ox, oy, oz, dx, dy, dz, t_min,
                   t_best, w_best);
      }
    }
  }

  // Boxes first .. first + n - 1 of `table` (rows of two float4), gated in
  // order for each ray g < k with bit g of `in` set, as `pass` gates them
  // for its lane: box i passes for ray g if ray g's interval in it meets
  // [t_min, bound()] with the bound as it stands when i is reached.  Lane
  // g * split + sub holds ray g (o, iv) and takes its intervals of boxes
  // sub, sub + split, ... a run of `split` at a time; a ballot finds the
  // next box that any ray passes, and visit(i, rays) runs on every lane
  // with the rays (bit g) box i passes for, and may lower their bounds,
  // which bound() reads back for the lane's ray.  So a ray's tests of a
  // run of boxes take one step of its lanes, not one step each.
  template <class Bound, class Visit>
  __device__ __forceinline__ void walk(const float4* table, int first, int n,
                                       int k, int split, unsigned in,
                                       float ox, float oy, float oz,
                                       float ivx, float ivy, float ivz,
                                       float t_min, Bound bound,
                                       Visit visit) const {
    const int lane = threadIdx.x % kWarpSize;
    const int g = lane / split, sub = lane % split;
    const bool mine = g < k && ((in >> g) & 1u);
    const unsigned run = split == kWarpSize ? kFullMask : (1u << split) - 1u;
    for (int b0 = 0; b0 < n; b0 += split) {
      const int end = min(n - b0, split);
      float near = 0.0f, far = 0.0f;
      if (mine && sub < end)
        slab_interval(table[2 * (first + b0 + sub)],
                      table[2 * (first + b0 + sub) + 1], ox, oy, oz, ivx,
                      ivy, ivz, t_min, near, far);
      for (int j = 0; j < end; ++j) {
        const unsigned bits = __ballot_sync(
            kFullMask,
            mine && sub >= j && sub < end && slab_pass(near, far, bound()));
        unsigned any = 0u;  // boxes of the run that some ray passes
        for (int h = 0; h < k; ++h) any |= (bits >> (h * split)) & run;
        if (any == 0u) break;
        j = __ffs(static_cast<int>(any)) - 1;
        unsigned rays = 0u;
        for (int h = 0; h < k; ++h)
          rays |= ((bits >> (h * split + j)) & 1u) << h;
        visit(first + b0 + j, rays);
      }
    }
  }

  // `pass` for a warp with few live lanes (the tail of a launch, where a
  // few deep paths' segments are a chain the launch waits on): the same
  // gates in the same order against the same bounds, so the same clusters
  // open for the same rays and the counters count the same tests, with
  // each ray's gates taken `split` = 32 / k at a time by walk.
  template <bool TRI>
  __device__ __forceinline__ void pass_split(const GateTables& gt,
                                             unsigned live, int k, int split,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float ivx, float ivy, float ivz,
                                             float t_min, bool active,
                                             float other, float& t_best,
                                             int& w_best,
                                             Counters& cnt) const {
    const int lane = threadIdx.x % kWarpSize;
    const int g = lane / split;
    const int src = g < k ? nth_lane(live, g) : lane;  // the lane's ray
    const int rank = __popc(live & ((1u << lane) - 1u));  // its own, live
    const float rox = __shfl_sync(kFullMask, ox, src);
    const float roy = __shfl_sync(kFullMask, oy, src);
    const float roz = __shfl_sync(kFullMask, oz, src);
    const float rivx = __shfl_sync(kFullMask, ivx, src);
    const float rivy = __shfl_sync(kFullMask, ivy, src);
    const float rivz = __shfl_sync(kFullMask, ivz, src);
    float gb = __shfl_sync(kFullMask, fminf(t_best, other), src);
    auto bound = [&] { return gb; };
    auto open = [&](int c, unsigned rays) {
      const bool need_me = active && ((rays >> rank) & 1u);
      const unsigned need = __ballot_sync(kFullMask, need_me);
      const int m = gt.counts[c];
      if (need_me) {
        ++cnt.clusters;
        if (TRI)
          cnt.tri_slots += m;
        else
          cnt.sph_slots += m;
      }
      ++cnt.warp_clusters;
      load_members<TRI>(c, m);
      sweep<TRI>(c, m, need, need_me, ox, oy, oz, dx, dy, dz, t_min, t_best,
                 w_best);
      gb = __shfl_sync(kFullMask, fminf(t_best, other), src);
    };
    if (active) cnt.boxes += gt.ks;
    walk(gt.supers, 0, gt.ks, k, split, (1u << k) - 1u, rox, roy, roz, rivx,
         rivy, rivz, t_min, bound, [&](int s, unsigned rays) {
           const int c0 = gt.starts[s], c1 = gt.starts[s + 1];
           if (c1 - c0 == 1) {
             open(c0, rays);
             return;
           }
           if (active && ((rays >> rank) & 1u)) cnt.boxes += c1 - c0;
           walk(gt.boxes, c0, c1 - c0, k, split, rays, rox, roy, roz, rivx,
                rivy, rivz, t_min, bound, open);
         });
  }

  // The closest hit of the rays of the warp's live lanes; with kWalk (K3t)
  // a warp with few of them live walks their gates together (pass_split).
  // K3 keeps the lane-by-lane gates: compiled into it, the walk's code
  // spilled three times the bytes and slowed it by up to a fifth.
  template <bool kWalk>
  __device__ __forceinline__ void closest_hit(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float t_min, bool active,
                                              Hit& h, Counters& cnt) const {
    const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
    float t_s = kBig, t_t = kBig;
    int w_s = INT_MAX, w_t = INT_MAX;
    unsigned live = 0u;
    int k = 0, split = 1;
    if (kWalk) {
      live = __ballot_sync(kFullMask, active);
      k = __popc(live);
      split = frt::lanes_per_ray(k, kWarpSize);
    }
    if (kWalk && split >= kMinWalkSplit) {
      if (ns > 0)
        pass_split<false>(sg, live, k, split, ox, oy, oz, dx, dy, dz, ivx,
                          ivy, ivz, t_min, active, kBig, t_s, w_s, cnt);
      if (nt > 0)
        pass_split<true>(tg, live, k, split, ox, oy, oz, dx, dy, dz, ivx,
                         ivy, ivz, t_min, active, t_s, t_t, w_t, cnt);
    } else {
      if (ns > 0)
        pass<false>(sg, ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, t_min, active,
                    kBig, t_s, w_s, cnt);
      if (nt > 0)
        pass<true>(tg, ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, t_min, active,
                   t_s, t_t, w_t, cnt);
    }
    h.w_s = t_s < kBig ? w_s : 0;
    h.w_t = t_t < kBig ? w_t : 0;
    h.is_tri = t_t < t_s;
    h.t = h.is_tri ? t_t : t_s;
  }

  __device__ __forceinline__ void closest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, bool active, Hit& h,
                                          Counters& cnt) const {
    closest_hit<false>(ox, oy, oz, dx, dy, dz, t_min, active, h, cnt);
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

// K3t's scene: the clustered scene whose closest hit walks the gates of a
// warp's few live rays together.
struct RecordClusterScene : ClusterScene {
  __device__ __forceinline__ void closest(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, bool active, Hit& h,
                                          Counters& cnt) const {
    closest_hit<true>(ox, oy, oz, dx, dy, dz, t_min, active, h, cnt);
  }
};

int chunk_of(int spp) { return spp < kMaxChunk ? spp : kMaxChunk; }

__host__ __device__ int scene_smem_bytes(const ClusterScene& s) {
  return ClusterScene::smem_bytes(s.ns, s.nt, s.sg.ks, s.sg.kc, s.tg.ks,
                                  s.tg.kc);
}

// K3.  At most 96 registers (five blocks an SM): on the card, 2.9 ms on
// field20000 against 3.1-3.3 at 128 (116 used) and 3.5 at 168
// (probes/mega_grid.py, PERF.md).
__global__ void __launch_bounds__(kThreads, 5)
    mega_clustered_kernel(const ClusterScene scene,
                          const float* __restrict__ camp,
                          const PathParams pp, const RenderLaunch ln,
                          float* __restrict__ rad, int* __restrict__ segs,
                          int* __restrict__ sweeps) {
  extern __shared__ float4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  ClusterScene sc = scene;
  sc.stage(base);
  const CameraRow cam = frt::load_camera(camp);
  frt::render_warp<false>(sc, cam, pp, ln, base + scene_smem_bytes(scene),
                          rad, segs, nullptr, nullptr, sweeps);
}

// K3t: K2b's recorder on the clustered scene.  At most 128 registers (four
// blocks an SM, 64 bytes spilled): three (168 registers, none spilled) were
// no faster at 2^17 rays, five and six slower (probes/mega_grid.py,
// PERF.md).
__global__ void __launch_bounds__(kThreads, 4)
    record_clustered_kernel(const RecordClusterScene scene,
                            const float* __restrict__ camp,
                            const PathParams pp, const RecordLaunch ln,
                            int* __restrict__ tape, int* __restrict__ its,
                            int* __restrict__ sweeps) {
  extern __shared__ float4 smem[];
  RecordClusterScene sc = scene;
  sc.stage(reinterpret_cast<unsigned char*>(smem));
  const CameraRow cam = frt::load_camera(camp);
  frt::record_warp(sc, cam, pp, ln, tape, its, nullptr, sweeps);
}

ClusterScene make_scene(const float* sph, const float* mx,
                        const float* sph_boxes, const float* sph_super,
                        const int* sph_starts, const int* sph_counts,
                        const float* tri, const float* tri_boxes,
                        const float* tri_super, const int* tri_starts,
                        const int* tri_counts, int ns, int nt, int ks,
                        int kts, int sp, int tp) {
  ClusterScene s;
  s.sph = sph;
  s.mx = reinterpret_cast<const float4*>(mx);
  s.tri = tri;
  s.sg = GateTables{reinterpret_cast<const float4*>(sph_super),
                    reinterpret_cast<const float4*>(sph_boxes), sph_counts,
                    sph_starts, ks, sp / kSlots};
  s.tg = GateTables{reinterpret_cast<const float4*>(tri_super),
                    reinterpret_cast<const float4*>(tri_boxes), tri_counts,
                    tri_starts, kts, tp / kSlots};
  s.ns = ns;
  s.nt = nt;
  s.sp = sp;
  s.tp = tp;
  return s;
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over `num_pixels` pixels of the nx x ny image
// starting at global pixel `pix0` (pixels past the image are not traced);
// writes rad (num_pixels, 3) f32, segs (num_pixels,) i32 and sweeps
// (num_pixels, 6) i32 (ClusterCounters, then the warp's clusters and steps
// at the first pixel of its first group); `work` is one int of device
// scratch, the launch's counter of groups.  The tables are those of
// MegaClusteredPack; `sp` and `tp` are the sphere and triangle column
// counts.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_mega_clustered_render(
    const float* cam, const float* sph, const float* mx,
    const float* sph_boxes, const float* sph_super, const int* sph_starts,
    const int* sph_counts, const float* tri, const float* tri_boxes,
    const float* tri_super, const int* tri_starts, const int* tri_counts,
    int ns, int nt, int ks, int kts, int sp, int tp, unsigned int k0,
    unsigned int k1, int nx, int ny, int spp, int pix0, int num_pixels,
    int max_depth, float t_min, float* rad, int* segs, int* sweeps,
    int* work, void* stream) {
  const ClusterScene scene =
      make_scene(sph, mx, sph_boxes, sph_super, sph_starts, sph_counts, tri,
                 tri_boxes, tri_super, tri_starts, tri_counts, ns, nt, ks,
                 kts, sp, tp);
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const RenderLaunch ln{spp,        spp,     0,   pix0,
                        num_pixels, nx * ny, chunk_of(spp), work};
  if (num_pixels > 0) {
    const int bytes =
        scene_smem_bytes(scene) +
        frt::kRenderWarps *
            frt::warp_store_bytes(ln.chunk, ClusterCounters::kLane);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = static_cast<int>(cudaMemsetAsync(work, 0, sizeof(int), st));
    if (err != 0) return err;
    err = frt::allow_smem(mega_clustered_kernel, bytes);
    if (err != 0) return err;
    const int blocks = frt::render_blocks(mega_clustered_kernel, bytes,
                                          frt::pixel_groups(num_pixels));
    mega_clustered_kernel<<<blocks, kThreads, bytes, st>>>(
        scene, cam, pp, ln, rad, segs, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K3t on `stream` over ray ids [ray0, ray0 + num_rays); writes tape
// (max_depth + 1, num_rays) i32, its (num_rays,) i32 and sweeps (num_rays, 6)
// i32 (ClusterCounters, then the warp's clusters and steps at the first ray
// of its first window).  `work` is one int of device scratch, the launch's
// counter of windows.  Tables as for frt_mega_clustered_render.  Returns
// cudaGetLastError() after the launch.
int frt_record_clustered(
    const float* cam, const float* sph, const float* mx,
    const float* sph_boxes, const float* sph_super, const int* sph_starts,
    const int* sph_counts, const float* tri, const float* tri_boxes,
    const float* tri_super, const int* tri_starts, const int* tri_counts,
    int ns, int nt, int ks, int kts, int sp, int tp, unsigned int k0,
    unsigned int k1, int nx, int ny, int spp_total, int ray0, int num_rays,
    int max_depth, float t_min, int* tape, int* its, int* sweeps, int* work,
    void* stream) {
  const RecordClusterScene scene{
      make_scene(sph, mx, sph_boxes, sph_super, sph_starts, sph_counts, tri,
                 tri_boxes, tri_super, tri_starts, tri_counts, ns, nt, ks,
                 kts, sp, tp)};
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const RecordLaunch ln{ray0, num_rays, spp_total, work};
  if (num_rays > 0) {
    const int bytes = scene_smem_bytes(scene);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = static_cast<int>(cudaMemsetAsync(work, 0, sizeof(int), st));
    if (err == 0) err = frt::allow_smem(record_clustered_kernel, bytes);
    if (err != 0) return err;
    const int windows =
        (num_rays + frt::kRecordWindow - 1) / frt::kRecordWindow;
    const int blocks =
        frt::render_blocks(record_clustered_kernel, bytes, windows);
    record_clustered_kernel<<<blocks, kThreads, bytes, st>>>(
        scene, cam, pp, ln, tape, its, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
