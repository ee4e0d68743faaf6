// K16 and K17 on Hopper: the row gathers of the differentiable scan and
// their transpose, the device form of kernels/gather_rows.py's plain
// versions (gather_plain, row_sum_plain), which replace the gathers of the
// JAX package's recompute_hit and scatter (first_raytracer_tpu/render/
// integrator.py:155-156, materials/scatter.py:62, scene/textures.py:29-31)
// and the scatter-adds that jax.value_and_grad makes of them (diff/grad.py:
// 107), which XLA fused into the scan.
//
// The scan reads one row a ray a trip from each of the scene's row tables
// (scene/payload.py::row_tables: a sphere's centre and radius, (ns, 4); a
// triangle's vertices, (nt, 9); a material's 11 values, (nm, 11)), at the
// ray's clamped sphere, triangle and material ids.  A launch takes up to
// three segments, each a table, its (n,) int64 row indices and its output,
// so that a trip's gathers cost one launch and their sums one more.
//
// K16 (`row_tile_kernel`): a block takes a tile of kTileRays rays of one
// segment.  Each thread reads one ray's index once, clamps it into [0,
// rows) (memory safety; the callers clamp their ids first, as
// recompute_hit does) and leaves the row in shared memory; then the block
// writes the tile's (rays, cols) output, which is contiguous, 16 bytes a
// thread, each 16 bytes' values read from the table through __ldg (the
// tables, a few KB, stay in L1).  An element's ray and column come from
// the high word of its 32-bit offset in the tile times 2^32 / cols rounded
// up, exact for the tile's elements (fewer than 2^32 / cols of them: cols
// < 4096), not a division, and the tile's offset is a 32-bit product: the
// launcher (frt_gather_rows_bits) takes this path where
// every segment has n cols and rows cols under 2^31, cols under 4096 and a
// 16-byte-aligned output, else the int64 path, `row_gather_kernel`, one
// thread an element with int64 indices and a division.  A gather is exact:
// K16 equals index_select bit for bit on both paths.
//
// K17 (`row_sum_kernel`): the gradient of each table row, the sum over the
// rays that read it of their (n, cols) gradients, the same bits whatever
// the order of the rays and whatever zeros are added.  A float sum
// regroups with the order (torch's indexing backward adds a row's rays in
// the order its sort leaves them; an atomicAdd in the order the warps
// arrive), so the sum is taken in integers instead, which are associative:
//   1. every (row, column) takes the largest exponent field E of the
//      values added to it (zeros add nothing) and flags NaN, +Inf and -Inf;
//   2. each finite value g is scaled to fixed point with F = 61 fraction
//      bits under that exponent, q = rint(g 2^(F - E + 1023)), |q| <=
//      2^62, exactly as the plain version does (two multiplications by
//      powers of two, each exact, then round to nearest even), split into
//      its high and low 32 bits, q = hi 2^32 + lo with 0 <= lo < 2^32, and
//      each part summed in an int64 (modulo 2^64, so the order and the
//      grouping cannot matter; for fewer than 2^31 rays neither sum can
//      overflow, and F depends on nothing of the launch, so rays added
//      with zero gradients change no bit);
//   3. each (row, column) is converted back: the low sum's carry moved
//      into the high one, float64(hi) 2^32 + float64(lo), times 2^(E -
//      1023 - F) in two exact steps, then the table's type: NaN where a
//      NaN or both infinities were added, else the infinity added, else
//      that value (0.0 where nothing was added, as torch's sum into zeros
//      gives).
// A value loses only what falls below 2^(E - 1023 - F): a row's sum is
// within n_row 2^(E - 1024 - F) of the exact one before its conversion,
// which rounds it at most three times (the high sum to float64, the add,
// the table's type).  The plain version takes the same steps.
//
// The three steps are one launch of at most the resident blocks, of
// kSumThreads threads.  The rays are cut into `chunks` contiguous ranges
// of at most kSumThreads rays (one a resident block at 2^17 rays); a
// block takes them by ticket (an atomic counter), so in step 1 and again
// in step 2 it takes ranges until none is left.  In a range a thread
// takes its ray and walks its columns, kColChunk columns' values loaded at
// once.  The lanes of a warp on one row (__match_any_sync, once a
// segment) reduce each value together: the warp's largest group (most
// often the ground's row) by full-warp redux.sync, the other groups by
// shuffles in log2 steps (a tree computed once a segment, shallow without
// the largest group).  Step 1 reduces the exponent field and the flags
// packed in 32 bits; step 2 each q in three 21-bit limbs, q = a 2^42 + b
// 2^21 + c, whose sums over a warp fit 32 bits.  The group's lowest lane
// adds the result into the block's table in shared memory: atomicMax and
// atomicOr of (E, flags) in step 1, 32-bit atomicAdd of the limbs in step
// 2 (their sums hold a range).  At the end of step 1, and of each range
// in step 2, the block flushes the entries it touched to the launch's
// table in global memory, one atomic an entry and word, so the ground
// sphere's row, which most rays read, takes one global atomic a block a
// column and word, not one a warp.  Step 2's limb sums go there as hi
// 2^32 + lo with 0 <= lo < 2^32: the same integer as the sums of the rays'
// own high and low words, which is all that the conversion reads; each
// low word added is under 2^32 and there are fewer of them than rays, so
// the low sum still holds fewer than 2^31 rays.  Then the block adds the ranges it took to the
// step's count with release semantics.  Step 2 waits until step 1's count
// holds every range (acquire), and reads E for every entry; the
// conversion waits likewise for step 2's count and is shared out by
// ticket in tiles of kSumThreads entries.  This is the shared path, taken
// where the block's table (kEntryBytes an entry over all segments, 16 for
// the limbs, 4 for E, the flags over the first limb in step 1) fits
// kSharedBudget; a larger launch takes the global path, the same launch
// with each group's lowest lane adding hi and lo to the global table, and
// E read from it in step 2.  Both give the same bits.
//
// Why the waits cannot deadlock, in a CUDA graph or eagerly, whatever the
// grid and however many of its blocks are resident at once: a block waits
// only after it has taken ranges of that step until none was left and
// flushed and counted them, so every range is held by a block that is
// running and waits for nothing before counting it; each count therefore
// reaches every range.  A block that finds no range left still counts
// nothing and goes on.  Nothing requires the blocks to be co-resident
// (the host emulation runs them one after another, or interleaved).
//
// The scratch, the global table (two uint64 sums and an (E, flags) pair of
// int32 an entry) and the counters, is the caller's, zeroed here by a
// memset: a graph node when the launch is captured, and no host sync.  A
// trip costs the memset and one kernel node.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // K16's blocks
constexpr int kTileRays = 256;     // K16: rays a tile, one a thread
constexpr int kMaxTileCols = 4095; // K16's 32-bit path: exact division
constexpr int kSumThreads = 1024;  // K17's blocks
constexpr int kColChunk = 4;       // K17: a ray's columns loaded at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSegments = 3;
// K17's shared path: a block's table of every entry, kEntryBytes each,
// plus its ticket, within this many bytes of shared memory (an H100 block
// takes up to 227 KB); the final scene's 7,290 entries take 145,816.
constexpr int64_t kSharedBudget = 200 * 1024;
constexpr int kEntryBytes = 20;
constexpr int kSumHead = 16;  // the block's ticket, in its shared memory
// K17's counters after the global table: the tickets and counts of steps
// 1 and 2, and the conversion's tickets.
constexpr int kCounters = 5;

struct Segment {
  const void* table;    // (rows, cols) of T; K17: the (n, cols) gradient
  const int64_t* idx;   // (n,) row indices
  void* out;            // K16: (n, cols) of T; K17: (rows, cols) of T
  int64_t rows;
  int cols;
  int64_t blocks;       // K16: the segment's blocks of the launch
  int64_t base;         // K17: its first entry in the launch's tables
  uint64_t magic;       // K16's 32-bit path: 2^32 / cols, rounded up
};

struct Segments {
  Segment s[kMaxSegments];
  int count;
  int64_t n;  // rays
};

// F: K17's fraction bits under a column's largest exponent.
constexpr int kFracBits = 61;

// The segment that block b of a launch belongs to, and b's block in it
// (the segments read at constant indices, so that they stay parameters).
template <class I>
__device__ __forceinline__ Segment segment_of(const Segments& a, I* b) {
  Segment s = a.s[0];
  bool later = true;
#pragma unroll
  for (int k = 0; k + 1 < kMaxSegments; ++k) {
    later = later && k + 1 < a.count && *b >= a.s[k].blocks;
    if (later) {
      *b -= static_cast<I>(a.s[k].blocks);
      s = a.s[k + 1];
    }
  }
  return s;
}

__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t rows) {
  return i < 0 ? 0 : (i >= rows ? rows - 1 : i);
}

// K16's int64 path: one thread an output element.
template <class T>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(Segments a) {
  int64_t b = blockIdx.x;
  const Segment s = segment_of(a, &b);
  const int64_t e = b * kThreads + threadIdx.x;
  if (e >= a.n * s.cols) return;
  const int64_t i = e / s.cols;
  const int c = static_cast<int>(e - i * s.cols);
  const int64_t row = clamp_row(__ldg(s.idx + i), s.rows);
  static_cast<T*>(s.out)[e] =
      __ldg(static_cast<const T*>(s.table) + row * s.cols + c);
}

// 16 bytes of values at p (16-byte aligned).
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// K16's 32-bit path: a tile of kTileRays rays, rows staged in shared
// memory (dynamic, so that the host emulation gives each block its own),
// the output written 16 bytes a thread.
template <class T>
__global__ void __launch_bounds__(kThreads) row_tile_kernel(Segments a) {
  extern __shared__ int4 tile_rows[];
  int* rows = reinterpret_cast<int*>(tile_rows);
  int b = blockIdx.x;
  const Segment s = segment_of(a, &b);
  const int n = static_cast<int>(a.n);
  const int cols = s.cols;
  const int r0 = b * kTileRays;
  const int m = min(kTileRays, n - r0);
  const int t = threadIdx.x;
  for (int r = t; r < m; r += kThreads)
    rows[r] = static_cast<int>(clamp_row(__ldg(s.idx + r0 + r), s.rows));
  __syncthreads();
  constexpr int kVec = 16 / sizeof(T);
  const int elems = m * cols;
  const T* table = static_cast<const T*>(s.table);
  T* out = static_cast<T*>(s.out) + r0 * cols;
  for (int e = t * kVec; e < elems; e += kThreads * kVec) {
    int r = static_cast<int>((static_cast<uint64_t>(e) * s.magic) >> 32);
    int c = e - r * cols;
    T v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = e + j < elems ? __ldg(table + rows[r] * cols + c) : T(0);
      if (++c == cols) {
        c = 0;
        ++r;
      }
    }
    if (e + kVec <= elems) {
      store16(out + e, v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (e + j < elems) out[e + j] = v[j];
    }
  }
}

// The shuffle tree of a warp's lanes that share a row: at each of `steps`
// steps a lane still in the tree adds the partial of the next lane above
// it still in the tree (src), and half the lanes leave it; the group's
// lowest lane ends with the total.  Computed once a segment and range.
struct PeerTree {
  int steps;
  int src[5];
  unsigned take;  // bit k: this lane adds src[k]'s partial at step k
  bool leader;
};

__device__ __forceinline__ PeerTree peer_tree(unsigned peers) {
  const int lane = threadIdx.x & 31;
  PeerTree t;
  t.steps = 0;
  t.take = 0;
  t.leader = (__ffs(static_cast<int>(peers)) - 1) == lane;
  unsigned above = peers & (0xfffffffeu << lane);
  int rank = __popc(peers & ((1u << lane) - 1u));
  // Unrolled, so that src stays in registers: a group of 32 takes 5 steps.
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    t.src[k] = 0;
    if (__any_sync(kFull, above != 0)) {  // the same on every lane
      const int next = __ffs(static_cast<int>(above));
      t.src[k] = next - 1;
      if (next != 0) t.take |= 1u << k;
      // The lanes at odd ranks gave their partial this step: out of the
      // tree.
      above &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
      t.steps = k + 1;
    }
  }
  return t;
}

template <class V, class Op>
__device__ __forceinline__ V reduce_peers(const PeerTree& t, V v, Op op) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < t.steps) {  // the same on every lane
      const V other = __shfl_sync(kFull, v, t.src[k]);
      if ((t.take >> k) & 1u) v = op(v, other);
    }
  }
  return v;
}

// The exponent field of g as the sum counts it: 0 for a zero (it adds
// nothing), at least 1 (a subnormal's bound), 2047 for NaN and the
// infinities; and their flag: 1 NaN, 2 +Inf, 4 -Inf.
__device__ __forceinline__ int exponent_field(double g, int* flag) {
  const long long bits = __double_as_longlong(g);
  const int field = static_cast<int>((bits >> 52) & 0x7ff);
  *flag = 0;
  if (field == 0x7ff) {
    *flag = (bits & 0xfffffffffffffll) != 0 ? 1 : (bits < 0 ? 4 : 2);
    return 0;
  }
  if (g == 0.0) return 0;
  return field > 1 ? field : 1;
}

// 2^k for k in [-1022, 1023].
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// The shift that scales a value of a (row, column) whose largest exponent
// field is E to F fraction bits under it, split in two halves so that
// each power of two is a normal float64.
__device__ __forceinline__ void shift_halves(int E, int* k1, int* k2) {
  const int k = kFracBits - (E - 1023);
  *k1 = k / 2;
  *k2 = k - *k1;
}

// The warp's largest group of lanes on one row (the lowest first lane
// among the largest): its lanes reduce with full-warp redux.sync, the
// others with the shuffle tree, which is shallower without them.
struct Hot {
  bool in;    // this lane is in the largest group
  bool lead;  // this lane leads it
};

__device__ __forceinline__ Hot hot_group(unsigned peers) {
  const int lane = threadIdx.x & 31;
  const int first = __ffs(static_cast<int>(peers)) - 1;
  const unsigned best = __reduce_max_sync(
      kFull, (static_cast<unsigned>(__popc(peers)) << 5) |
                 static_cast<unsigned>(31 - first));
  const int hot_first = 31 - static_cast<int>(best & 31u);
  return Hot{first == hot_first, lane == hot_first};
}

// Step 1's value of a lane, the exponent field in the low 16 bits and the
// flags above: the maximum of the one, the OR of the other.
struct MaxOr {
  __device__ __forceinline__ unsigned operator()(unsigned x,
                                                 unsigned y) const {
    return ((x | y) & 0xffff0000u) | max(x & 0xffffu, y & 0xffffu);
  }
};

struct Add {
  __device__ __forceinline__ unsigned operator()(unsigned x,
                                                 unsigned y) const {
    return x + y;
  }
};

template <class T>
__device__ __forceinline__ T to_type(double x);
template <>
__device__ __forceinline__ float to_type<float>(double x) {
  return __double2float_rn(x);
}
template <>
__device__ __forceinline__ double to_type<double>(double x) {
  return x;
}

// Step 3 for one entry: its (E, flags) and its two sums back to float64.
__device__ __forceinline__ double convert(int E, int flags,
                                          unsigned long long hi_sum,
                                          unsigned long long lo) {
  if ((flags & 1) || (flags & 6) == 6)
    return __longlong_as_double(0x7ff8000000000000ll);  // NaN
  if (flags)
    return __longlong_as_double(
        flags == 2 ? 0x7ff0000000000000ll
                   : static_cast<long long>(0xfff0000000000000ull));
  if (E == 0) return 0.0;
  const long long hi = static_cast<long long>(hi_sum) +
                       static_cast<long long>(lo >> 32);
  int k1, k2;
  shift_halves(E, &k1, &k2);
  return (__ll2double_rn(hi) * 4294967296.0 +
          __ll2double_rn(static_cast<long long>(lo & 0xffffffffull))) *
         pow2(-k1) * pow2(-k2);
}

// K17's launch: the segments (table: the gradient), their entries, the
// ranges of rays, and the global table and counters.
struct SumArgs {
  Segments a;
  int64_t entries;            // rows cols summed over the segments
  int64_t chunk;              // rays a range
  int64_t chunks;             // ranges, at least 1
  unsigned long long* acc;    // (entries, 2): the hi and lo sums
  int* meta;                  // (entries, 2): E and the flags
  unsigned long long* count;  // kCounters
};

// A counter as another block left it, at the scope of the device (made an
// acquire read by the fence that follows the wait).
__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
#if defined(__CUDA_ARCH__)
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
#else
  return *reinterpret_cast<const volatile unsigned long long*>(p);
#endif
}

// The block counts the `taken` ranges it flushed (every thread's atomics
// made visible first), then waits until the count holds all of them.
__device__ __forceinline__ void arrive_and_wait(const SumArgs& q,
                                                unsigned long long* count,
                                                long long taken) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (taken) atomicAdd(count, static_cast<unsigned long long>(taken));
    while (peek(count) < static_cast<unsigned long long>(q.chunks))
      __nanosleep(64);
    __threadfence();  // the reads after the wait become acquire reads
  }
  __syncthreads();
}

// A sum of q's limbs a 2^42 + b 2^21 + c (a the int32 sum's bits) as
// hi 2^32 + lo with 0 <= lo < 2^32, as the rays' own words would add up
// to it.
__device__ __forceinline__ void join_limbs(unsigned a, unsigned b,
                                           unsigned c, long long* hi,
                                           unsigned long long* lo) {
  const unsigned long long low =
      (static_cast<unsigned long long>(b) << 21) + c;
  *hi = static_cast<long long>(static_cast<int>(a)) * 1024 +
        static_cast<long long>(low >> 32);
  *lo = low & 0xffffffffull;
}

// A ray's values at columns [c0, c0 + kColChunk) of its gradient row g,
// loaded together (0 past the row's end and for a lane without a ray), so
// that a chunk waits for its loads once and its columns' reductions
// overlap.
template <class T>
__device__ __forceinline__ void load_chunk(const T* g, int c0, int cols,
                                           bool ray, T (&x)[kColChunk]) {
#pragma unroll
  for (int u = 0; u < kColChunk; ++u)
    x[u] = ray && c0 + u < cols ? __ldg(g + c0 + u) : T(0);
}

// Step 1 over the rays [r0, r1): each (row, column)'s largest exponent
// field and flags, into the block's table (ex, and the flags over the
// first word of each entry's limbs) or the global one.
template <class T, bool kShared>
__device__ __forceinline__ void exponents(const SumArgs& q, int64_t r0,
                                          int64_t r1, int* ex, int* flags) {
  const int64_t i = r0 + threadIdx.x;  // a range holds at most kSumThreads
  const bool ray = i < r1;
#pragma unroll
  for (int k = 0; k < kMaxSegments; ++k) {
    if (k >= q.a.count) break;
    const Segment& s = q.a.s[k];
    const int64_t row = ray ? clamp_row(__ldg(s.idx + i), s.rows) : -1;
    const unsigned peers = __match_any_sync(kFull, static_cast<int>(row));
    const Hot hot = hot_group(peers);
    const PeerTree tree =
        peer_tree(hot.in ? 1u << (threadIdx.x & 31) : peers);
    const T* g = static_cast<const T*>(s.table) + i * s.cols;
    const int64_t at = s.base + row * s.cols;
    for (int c0 = 0; c0 < s.cols; c0 += kColChunk) {
      T x[kColChunk];
      load_chunk(g, c0, s.cols, ray, x);
#pragma unroll
      for (int u = 0; u < kColChunk; ++u) {
        const int c = c0 + u;
        if (c >= s.cols) break;  // the same on every lane
        int flag = 0;
        const int e = exponent_field(static_cast<double>(x[u]), &flag);
        const unsigned own = (static_cast<unsigned>(flag) << 16) | e;
        const unsigned hot_e =
            __reduce_max_sync(kFull, hot.in ? own & 0xffffu : 0u);
        const unsigned hot_f =
            __reduce_or_sync(kFull, hot.in ? own >> 16 : 0u);
        const unsigned v = reduce_peers(tree, own, MaxOr());
        if (ray && (hot.lead || (tree.leader && !hot.in))) {
          const int top =
              static_cast<int>(hot.lead ? hot_e : v & 0xffffu);
          const int f = static_cast<int>(hot.lead ? hot_f : v >> 16);
          if (kShared) {
            if (top) atomicMax(ex + at + c, top);
            if (f) atomicOr(flags + 4 * (at + c), f);
          } else {
            int* m = q.meta + 2 * (at + c);
            if (top) atomicMax(m, top);
            if (f) atomicOr(m + 1, f);
          }
        }
      }
    }
  }
}

// Step 2 over the rays [r0, r1): each finite value in fixed point under
// its (row, column)'s exponent (from ex, or the global table), its limbs'
// sums added to the block's table in acc, or its high and low words to
// the global one.
template <class T, bool kShared>
__device__ __forceinline__ void accumulate(const SumArgs& q, int64_t r0,
                                           int64_t r1, const int* ex,
                                           unsigned long long* acc) {
  const int64_t i = r0 + threadIdx.x;  // a range holds at most kSumThreads
  const bool ray = i < r1;
#pragma unroll
  for (int k = 0; k < kMaxSegments; ++k) {
    if (k >= q.a.count) break;
    const Segment& s = q.a.s[k];
    const int64_t row = ray ? clamp_row(__ldg(s.idx + i), s.rows) : -1;
    const unsigned peers = __match_any_sync(kFull, static_cast<int>(row));
    const Hot hot = hot_group(peers);
    const PeerTree tree =
        peer_tree(hot.in ? 1u << (threadIdx.x & 31) : peers);
    const T* g = static_cast<const T*>(s.table) + i * s.cols;
    const int64_t at = s.base + row * s.cols;
    for (int c0 = 0; c0 < s.cols; c0 += kColChunk) {
      T x[kColChunk];
      load_chunk(g, c0, s.cols, ray, x);
#pragma unroll
      for (int u = 0; u < kColChunk; ++u) {
        const int c = c0 + u;
        if (c >= s.cols) break;  // the same on every lane
        // q in three 21-bit limbs, q = a 2^42 + b 2^21 + c (a signed,
        // |a| <= 2^20), whose sums over 32 lanes fit 32 bits.
        unsigned a = 0, b = 0, c21 = 0;
        const double y = static_cast<double>(x[u]);
        int flag = 0;
        if (exponent_field(y, &flag) != 0) {  // a zero for a dead lane
          int k1, k2;
          shift_halves(kShared ? ex[at + c] : __ldcg(q.meta + 2 * (at + c)),
                       &k1, &k2);
          const long long v = __double2ll_rn(y * pow2(k1) * pow2(k2));
          a = static_cast<unsigned>(static_cast<int>(v >> 42));
          b = static_cast<unsigned>(v >> 21) & 0x1fffffu;
          c21 = static_cast<unsigned>(v) & 0x1fffffu;
        }
        const unsigned hot_a = __reduce_add_sync(kFull, hot.in ? a : 0u);
        const unsigned hot_b = __reduce_add_sync(kFull, hot.in ? b : 0u);
        const unsigned hot_c = __reduce_add_sync(kFull, hot.in ? c21 : 0u);
        a = reduce_peers(tree, a, Add());
        b = reduce_peers(tree, b, Add());
        c21 = reduce_peers(tree, c21, Add());
        if (hot.lead) {
          a = hot_a;
          b = hot_b;
          c21 = hot_c;
        }
        if (ray && (hot.lead || (tree.leader && !hot.in))) {
          if (kShared) {  // the limbs' sums over the range, 32 bits
            unsigned* w = reinterpret_cast<unsigned*>(acc) + 4 * (at + c);
            if (a) atomicAdd(w, a);
            if (b) atomicAdd(w + 1, b);
            if (c21) atomicAdd(w + 2, c21);
          } else {
            long long hi;
            unsigned long long lo;
            join_limbs(a, b, c21, &hi, &lo);
            unsigned long long* p = acc + 2 * (at + c);
            if (hi != 0) atomicAdd(p, static_cast<unsigned long long>(hi));
            if (lo != 0) atomicAdd(p + 1, lo);
          }
        }
      }
    }
  }
}

// Step kStep's ranges taken by ticket (`ticket` the step's counter), each
// run through exponents (step 1) or accumulate (step 2); returns the
// ranges taken.  The first ticket is in *head (shared) on entry; each
// range's successor is asked for before the range is run, so its
// answer's wait hides behind the range.
template <class T, bool kShared, int kStep>
__device__ __forceinline__ long long take_ranges(
    const SumArgs& q, unsigned long long* ticket, long long* head, int* ex,
    unsigned long long* acc) {
  long long taken = 0;
  for (;;) {
    const long long c = *head;
    if (c >= q.chunks) break;
    unsigned long long next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1ull);
    const int64_t r0 = c * q.chunk, r1 = min(q.a.n, r0 + q.chunk);
    if (kStep == 1) {
      exponents<T, kShared>(q, r0, r1, ex, reinterpret_cast<int*>(acc));
    } else {
      accumulate<T, kShared>(q, r0, r1, ex, kShared ? acc : q.acc);
      if (kShared) {
        // The range's limb sums (which hold a range of at most
        // kSumThreads rays) into the global table, then cleared.
        __syncthreads();
        unsigned* w = reinterpret_cast<unsigned*>(acc);
        for (int64_t j = threadIdx.x; j < q.entries; j += kSumThreads) {
          const unsigned a = w[4 * j], b = w[4 * j + 1], c = w[4 * j + 2];
          if (a | b | c) {
            long long hi;
            unsigned long long lo;
            join_limbs(a, b, c, &hi, &lo);
            if (hi) atomicAdd(q.acc + 2 * j, static_cast<unsigned long long>(hi));
            if (lo) atomicAdd(q.acc + 2 * j + 1, lo);
            w[4 * j] = w[4 * j + 1] = w[4 * j + 2] = 0;
          }
        }
      }
    }
    ++taken;
    __syncthreads();  // every thread has read *head
    if (threadIdx.x == 0) *head = static_cast<long long>(next);
    __syncthreads();
  }
  __syncthreads();  // every thread has read the last *head
  return taken;
}

template <class T, bool kShared>
__global__ void __launch_bounds__(kSumThreads) row_sum_kernel(SumArgs q) {
  extern __shared__ int4 sum_shared[];
  long long* head = reinterpret_cast<long long*>(sum_shared);
  unsigned long long* acc =
      reinterpret_cast<unsigned long long*>(sum_shared) + kSumHead / 8;
  int* ex = reinterpret_cast<int*>(acc + (kShared ? 2 * q.entries : 0));
  int* flags = reinterpret_cast<int*>(acc);  // step 1: over each entry's hi
  const int t = threadIdx.x;

  // Step 1: the exponents and flags.
  if (t == 0) *head = static_cast<long long>(atomicAdd(q.count, 1ull));
  if (kShared)
    for (int64_t j = t; j < q.entries; j += kSumThreads) {
      acc[2 * j] = 0;
      ex[j] = 0;
    }
  __syncthreads();
  long long taken = take_ranges<T, kShared, 1>(q, q.count, head, ex, acc);
  if (kShared) {
    for (int64_t j = t; j < q.entries; j += kSumThreads) {
      const int e = ex[j], f = flags[4 * j];
      if (e) atomicMax(q.meta + 2 * j, e);
      if (f) atomicOr(q.meta + 2 * j + 1, f);
    }
  }
  // Step 2's first ticket, then the wait for every range of step 1.
  if (t == 0) *head = static_cast<long long>(atomicAdd(q.count + 2, 1ull));
  arrive_and_wait(q, q.count + 1, taken);

  // Step 2: the fixed-point sums.
  if (kShared) {
    // Every entry's E, kColChunk loads a thread in flight at once.
    for (int64_t j0 = t; j0 < q.entries; j0 += kColChunk * kSumThreads) {
      int e[kColChunk];
#pragma unroll
      for (int u = 0; u < kColChunk; ++u) {
        const int64_t j = j0 + u * kSumThreads;
        e[u] = j < q.entries ? __ldcg(q.meta + 2 * j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kColChunk; ++u) {
        const int64_t j = j0 + u * kSumThreads;
        if (j < q.entries) {
          ex[j] = e[u];
          acc[2 * j] = 0;
          acc[2 * j + 1] = 0;
        }
      }
    }
    __syncthreads();
  }
  taken = take_ranges<T, kShared, 2>(q, q.count + 2, head, ex, acc);
  if (t == 0) *head = static_cast<long long>(atomicAdd(q.count + 4, 1ull));
  arrive_and_wait(q, q.count + 3, taken);

  // Step 3: the entries back to the tables' type, in tiles by ticket.
  const int64_t tiles = (q.entries + kSumThreads - 1) / kSumThreads;
  for (;;) {
    const long long tile = *head;
    if (tile >= tiles) break;
    unsigned long long next = 0;
    if (t == 0) next = atomicAdd(q.count + 4, 1ull);
    const int64_t j = tile * kSumThreads + t;
    if (j < q.entries) {
      const double y = convert(__ldcg(q.meta + 2 * j),
                               __ldcg(q.meta + 2 * j + 1),
                               __ldcg(q.acc + 2 * j), __ldcg(q.acc + 2 * j + 1));
      void* out = q.a.s[0].out;
      int64_t base = 0;
#pragma unroll
      for (int k = 1; k < kMaxSegments; ++k)
        if (k < q.a.count && j >= q.a.s[k].base) {
          out = q.a.s[k].out;
          base = q.a.s[k].base;
        }
      static_cast<T*>(out)[j - base] = to_type<T>(y);
    }
    __syncthreads();
    if (t == 0) *head = static_cast<long long>(next);
    __syncthreads();
  }
}

int64_t blocks_for(int64_t n, int64_t per) { return (n + per - 1) / per; }

// The launch's segments from the host descriptor `desc`: five int64 a
// segment (the table or gradient, the indices, the output, rows, columns);
// those without rows or columns are left out.
bool segments(const int64_t* desc, int count, int64_t n, Segments* a) {
  if (count < 0 || count > kMaxSegments) return false;
  *a = Segments{};
  a->n = n;
  int64_t base = 0;
  for (int k = 0; k < count; ++k) {
    const int64_t* d = desc + 5 * k;
    if (d[3] > 0 && d[4] > 0) {
      a->s[a->count++] = Segment{
          reinterpret_cast<const void*>(d[0]),
          reinterpret_cast<const int64_t*>(d[1]),
          reinterpret_cast<void*>(d[2]), d[3], static_cast<int>(d[4]), 0,
          base, 0};
      base += d[3] * d[4];
    }
  }
  return true;
}

// K16's index width: 32 where every segment's n cols and rows cols are
// under 2^31, its cols under kMaxTileCols + 1 and its output 16-byte
// aligned, else 64.
int index_bits(const Segments& a) {
  for (int k = 0; k < a.count; ++k) {
    const Segment& s = a.s[k];
    if (s.cols > kMaxTileCols || a.n * s.cols >= (int64_t{1} << 31) ||
        s.rows * s.cols >= (int64_t{1} << 31) ||
        reinterpret_cast<uintptr_t>(s.out) % 16 != 0)
      return 64;
  }
  return 32;
}

template <class T>
int gather(const int64_t* desc, int count, int64_t n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Segments a;
  if (!segments(desc, count, n, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = 0;
  if (index_bits(a) == 32) {
    for (int k = 0; k < a.count; ++k) {
      Segment& s = a.s[k];
      blocks += s.blocks = blocks_for(n, kTileRays);
      s.magic = 0xffffffffull / static_cast<uint64_t>(s.cols) + 1;
    }
    if (blocks > 0)
      row_tile_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                           kTileRays * sizeof(int), st>>>(a);
  } else {
    for (int k = 0; k < a.count; ++k)
      blocks += a.s[k].blocks = blocks_for(n * a.s[k].cols, kThreads);
    if (blocks > 0)
      row_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K17's resident blocks of kernel `k` at `bytes` of dynamic shared memory.
template <class K>
cudaError_t resident_blocks(K kernel, int bytes, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kSumThreads, bytes);
  *blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  return err;
}

int64_t shared_bytes(int64_t entries) {
  return kSumHead + kEntryBytes * entries;
}

// K17's resident blocks for a launch of `entries`, on its path.
template <class T>
cudaError_t sum_resident(int64_t entries, int* blocks) {
  if (shared_bytes(entries) <= kSharedBudget)
    return resident_blocks(row_sum_kernel<T, true>,
                           static_cast<int>(shared_bytes(entries)), blocks);
  return resident_blocks(row_sum_kernel<T, false>, kSumHead, blocks);
}

template <class T>
int row_sum(const int64_t* desc, int count, int64_t n, int64_t* work,
            int64_t words, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  SumArgs q{};
  if (!segments(desc, count, n, &q.a))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < q.a.count; ++k) {
    if (q.a.s[k].rows >= (int64_t{1} << 31))  // rows match as int32
      return static_cast<int>(cudaErrorInvalidValue);
    q.entries += q.a.s[k].rows * q.a.s[k].cols;
  }
  if (q.entries == 0) return 0;
  if (words < 3 * q.entries + kCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  // The scratch: the hi and lo sums an entry, the (E, flags) pairs, the
  // counters.
  q.acc = reinterpret_cast<unsigned long long*>(work);
  q.meta = reinterpret_cast<int*>(work + 2 * q.entries);
  q.count = reinterpret_cast<unsigned long long*>(work + 3 * q.entries);
  err = cudaMemsetAsync(work, 0, (3 * q.entries + kCounters) *
                                     sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool shared = shared_bytes(q.entries) <= kSharedBudget;
  const int bytes =
      static_cast<int>(shared ? shared_bytes(q.entries) : kSumHead);
  int resident = 1;
  err = sum_resident<T>(q.entries, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Ranges of at most kSumThreads rays: a thread's one ray, and the
  // shared path's limb sums hold it.
  const int64_t grid =
      std::max<int64_t>(1, std::min<int64_t>(resident,
                                             blocks_for(n, kSumThreads)));
  q.chunk = std::max<int64_t>(
      1, std::min<int64_t>(kSumThreads, blocks_for(n, grid)));
  q.chunks = std::max<int64_t>(1, blocks_for(n, q.chunk));
  if (shared)
    row_sum_kernel<T, true><<<static_cast<unsigned>(grid), kSumThreads,
                              bytes, st>>>(q);
  else
    row_sum_kernel<T, false><<<static_cast<unsigned>(grid), kSumThreads,
                               bytes, st>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K16 on `stream` over n rays: for each of the `count` segments
// of the host array desc (five int64 each: a table's device pointer, its
// (n,) int64 indices', the (n, cols) output's, rows, cols), out = table[
// idx] row by row, on the index width of frt_gather_rows_bits.
int frt_gather_rows_f32(const int64_t* desc, int count, int64_t n,
                        void* stream) {
  return gather<float>(desc, count, n, stream);
}

int frt_gather_rows_f64(const int64_t* desc, int count, int64_t n,
                        void* stream) {
  return gather<double>(desc, count, n, stream);
}

// The index width K16's launcher takes for desc: 32 or 64 (-1: a bad
// descriptor).
int frt_gather_rows_bits(const int64_t* desc, int count, int64_t n) {
  Segments a;
  if (!segments(desc, count, n, &a)) return -1;
  return index_bits(a);
}

// Launches K17 on `stream` over n rays: for each segment of desc (the (n,
// cols) gradient, its indices, the (rows, cols) output, rows, cols), out =
// the sum of the gradient's rows by index (module comment); work holds
// `words` int64, at least 3 entries + kCounters (entries: rows cols summed
// over the segments; refused if fewer), and is zeroed here; n < 2^31.
int frt_row_sum_f32(const int64_t* desc, int count, int64_t n,
                    int64_t* work, int64_t words, void* stream) {
  return row_sum<float>(desc, count, n, work, words, stream);
}

int frt_row_sum_f64(const int64_t* desc, int count, int64_t n,
                    int64_t* work, int64_t words, void* stream) {
  return row_sum<double>(desc, count, n, work, words, stream);
}

// Whether a K17 launch of `entries` takes the shared path (1) or the
// global one (0).
int frt_row_sum_shared(int64_t entries) {
  return shared_bytes(entries) <= kSharedBudget ? 1 : 0;
}

// K17's resident blocks for a launch of `entries` in float64 (f64 1) or
// float32, on its path: the most blocks it launches (-1 on an error).
int frt_row_sum_resident(int64_t entries, int f64) {
  int blocks = 0;
  const cudaError_t err = f64 ? sum_resident<double>(entries, &blocks)
                              : sum_resident<float>(entries, &blocks);
  return err == cudaSuccess ? blocks : -1;
}

}  // extern "C"
