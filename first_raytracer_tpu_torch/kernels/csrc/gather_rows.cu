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
// K16 (`row_gather_kernel`): out[i, c] = table[idx[i], c], one thread an
// element of the (n, cols) outputs, so the writes are coalesced and the
// rows, a few KB, come from the caches.  A gather is exact: K16 equals
// index_select bit for bit.  An index outside [0, rows) is clamped into it
// (memory safety; the callers clamp their ids first, as recompute_hit
// does).
//
// K17 (`row_exponent_kernel`, `row_accumulate_kernel`,
// `row_round_kernel`): the gradient of each table row, the sum over the
// rays that read it of their (n, cols) gradients, the same bits whatever
// the order of the rays and whatever zeros are added.  A float sum regroups with the order (torch's
// indexing backward adds a row's rays in the order its sort leaves them;
// an atomicAdd in the order the warps arrive), so the sum is taken in
// integers instead, which are associative:
//   1. every (row, column) takes the largest exponent field E of the
//      values added to it (atomicMax; zeros add nothing) and flags NaN,
//      +Inf and -Inf (atomicOr);
//   2. each finite value g is scaled to fixed point with F = 61 fraction
//      bits under that exponent, q = rint(g 2^(F - E + 1023)), |q| <=
//      2^62, exactly as the plain version does (two multiplications by
//      powers of two, each exact, then round to nearest even), split into
//      its high and low 32 bits, q = hi 2^32 + lo with 0 <= lo < 2^32, and
//      each part summed in an int64 (unsigned atomicAdd: modulo 2^64, so
//      the order cannot matter; for fewer than 2^31 rays neither sum can
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
// In passes 1 and 2 a thread takes a ray and walks its columns; the lanes
// of a warp on one row (__match_any_sync) reduce their values by shuffles
// in log2 steps (a tree computed once a warp, shared by the columns) and
// the group's lowest lane makes the atomics, so the ground sphere's row,
// which most rays read, takes one atomic a warp a column and word.  The
// launch is bound by its bytes (the gradients read twice, in passes 1 and
// 2; the tables' few KB) and by the atomics on the hot row.
// The scratch (the pairs of int64 sums, then the exponents and flags as
// int32 pairs) is the caller's, zeroed here by a memset: a graph node when
// the launch is captured, and no host sync.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSegments = 3;

struct Segment {
  const void* table;    // (rows, cols) of T; K17: the (n, cols) gradient
  const int64_t* idx;   // (n,) row indices
  void* out;            // K16: (n, cols) of T; K17: (rows, cols) of T
  int64_t rows;
  int cols;
  int64_t blocks;       // the segment's blocks of the launch
  unsigned long long* acc;  // K17: (rows, cols) pairs of int64 sums
  int* meta;                // K17: (rows, cols) pairs of (E, flags)
};

struct Segments {
  Segment s[kMaxSegments];
  int count;
  int64_t n;  // rays
};

// F: K17's fraction bits under a column's largest exponent.
constexpr int kFracBits = 61;

// The segment that block b of a launch belongs to, and b's block in it.
__device__ __forceinline__ int segment_of(const Segments& a, int64_t* b) {
  int k = 0;
  while (k + 1 < a.count && *b >= a.s[k].blocks) {
    *b -= a.s[k].blocks;
    ++k;
  }
  return k;
}

__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t rows) {
  return i < 0 ? 0 : (i >= rows ? rows - 1 : i);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(Segments a) {
  int64_t b = blockIdx.x;
  const Segment& s = a.s[segment_of(a, &b)];
  const int64_t e = b * kThreads + threadIdx.x;
  if (e >= a.n * s.cols) return;
  const int64_t i = e / s.cols;
  const int c = static_cast<int>(e - i * s.cols);
  const int64_t row = clamp_row(__ldg(s.idx + i), s.rows);
  static_cast<T*>(s.out)[e] =
      __ldg(static_cast<const T*>(s.table) + row * s.cols + c);
}

// The shuffle tree of a warp's lanes that share a row: at each of `steps`
// steps a lane still in the tree adds the partial of the next lane above
// it still in the tree (src), and half the lanes leave it; the group's
// lowest lane ends with the total.  Computed once a warp for its rows.
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

struct MaxOr {
  __device__ __forceinline__ unsigned long long operator()(
      unsigned long long x, unsigned long long y) const {
    const unsigned lo = max(static_cast<unsigned>(x),
                            static_cast<unsigned>(y));
    return ((x | y) & 0xffffffff00000000ull) | lo;
  }
};

struct Add {
  __device__ __forceinline__ long long operator()(long long x,
                                                  long long y) const {
    return static_cast<long long>(static_cast<unsigned long long>(x) +
                                  static_cast<unsigned long long>(y));
  }
};

// Pass 1: each (row, column)'s largest exponent field and its flags.
template <class T>
__global__ void __launch_bounds__(kThreads)
    row_exponent_kernel(Segments a) {
  int64_t b = blockIdx.x;
  const Segment& s = a.s[segment_of(a, &b)];
  const int64_t i = b * kThreads + threadIdx.x;
  const bool ray = i < a.n;
  const int64_t row = ray ? clamp_row(__ldg(s.idx + i), s.rows) : -1;
  const PeerTree tree = peer_tree(__match_any_sync(kFull, row));
  const T* g = static_cast<const T*>(s.table);
  for (int c = 0; c < s.cols; ++c) {
    int flag = 0, e = 0;
    if (ray) e = exponent_field(static_cast<double>(g[i * s.cols + c]), &flag);
    const unsigned long long v = reduce_peers(
        tree,
        (static_cast<unsigned long long>(flag) << 32) |
            static_cast<unsigned>(e),
        MaxOr());
    if (ray && tree.leader) {
      int* m = s.meta + 2 * (row * s.cols + c);
      if (static_cast<unsigned>(v) != 0u)
        atomicMax(m, static_cast<int>(static_cast<unsigned>(v)));
      if ((v >> 32) != 0ull) atomicOr(m + 1, static_cast<int>(v >> 32));
    }
  }
}

// Pass 2: each finite value in fixed point under its (row, column)'s
// exponent, its high and low words summed in int64.
template <class T>
__global__ void __launch_bounds__(kThreads)
    row_accumulate_kernel(Segments a) {
  int64_t b = blockIdx.x;
  const Segment& s = a.s[segment_of(a, &b)];
  const int64_t i = b * kThreads + threadIdx.x;
  const bool ray = i < a.n;
  const int64_t row = ray ? clamp_row(__ldg(s.idx + i), s.rows) : -1;
  const PeerTree tree = peer_tree(__match_any_sync(kFull, row));
  const T* g = static_cast<const T*>(s.table);
  for (int c = 0; c < s.cols; ++c) {
    long long hi = 0, lo = 0;
    if (ray) {
      const double x = static_cast<double>(g[i * s.cols + c]);
      int flag = 0;
      if (exponent_field(x, &flag) != 0) {
        int k1, k2;
        shift_halves(s.meta[2 * (row * s.cols + c)], &k1, &k2);
        const long long q = __double2ll_rn(x * pow2(k1) * pow2(k2));
        hi = q >> 32;
        lo = q & 0xffffffffll;
      }
    }
    hi = reduce_peers(tree, hi, Add());
    lo = reduce_peers(tree, lo, Add());
    if (ray && tree.leader) {
      unsigned long long* acc = s.acc + 2 * (row * s.cols + c);
      if (hi != 0) atomicAdd(acc, static_cast<unsigned long long>(hi));
      if (lo != 0) atomicAdd(acc + 1, static_cast<unsigned long long>(lo));
    }
  }
}

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

// Pass 3: each (row, column)'s sum back to the table's type, once.
template <class T>
__global__ void __launch_bounds__(kThreads)
    row_round_kernel(Segments a) {
  int64_t b = blockIdx.x;
  const Segment& s = a.s[segment_of(a, &b)];
  const int64_t e = b * kThreads + threadIdx.x;
  if (e >= s.rows * s.cols) return;
  const int E = s.meta[2 * e], flags = s.meta[2 * e + 1];
  double y = 0.0;
  if ((flags & 1) || (flags & 6) == 6) {
    y = __longlong_as_double(0x7ff8000000000000ll);  // NaN
  } else if (flags) {
    y = __longlong_as_double(flags == 2 ? 0x7ff0000000000000ll
                                        : static_cast<long long>(
                                              0xfff0000000000000ull));
  } else if (E != 0) {
    const unsigned long long lo = s.acc[2 * e + 1];
    const long long hi = static_cast<long long>(s.acc[2 * e]) +
                         static_cast<long long>(lo >> 32);
    int k1, k2;
    shift_halves(E, &k1, &k2);
    y = (__ll2double_rn(hi) * 4294967296.0 +
         __ll2double_rn(static_cast<long long>(lo & 0xffffffffull))) *
        pow2(-k1) * pow2(-k2);
  }
  static_cast<T*>(s.out)[e] = to_type<T>(y);
}

int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

// The launch's segments from the host descriptor `desc`: five int64 a
// segment (the table or gradient, the indices, the output, rows, columns);
// those without rows or columns are left out.
bool segments(const int64_t* desc, int count, int64_t n, Segments* a) {
  if (count < 0 || count > kMaxSegments) return false;
  *a = Segments{};
  a->n = n;
  for (int k = 0; k < count; ++k) {
    const int64_t* d = desc + 5 * k;
    if (d[3] > 0 && d[4] > 0)
      a->s[a->count++] = Segment{
          reinterpret_cast<const void*>(d[0]),
          reinterpret_cast<const int64_t*>(d[1]),
          reinterpret_cast<void*>(d[2]), d[3], static_cast<int>(d[4]), 0,
          nullptr, nullptr};
  }
  return true;
}

template <class T>
int gather(const int64_t* desc, int count, int64_t n, void* stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Segments a;
  if (!segments(desc, count, n, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = 0;
  for (int k = 0; k < a.count; ++k)
    blocks += a.s[k].blocks = blocks_for(n * a.s[k].cols);
  if (blocks > 0)
    row_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int row_sum(const int64_t* desc, int count, int64_t n, int64_t* work,
            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Segments a;
  if (!segments(desc, count, n, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  // The scratch: each segment's pairs of sums, then its (E, flags) pairs.
  int64_t words = 0;
  for (int k = 0; k < a.count; ++k) {
    Segment& s = a.s[k];
    s.acc = reinterpret_cast<unsigned long long*>(work + words);
    s.meta = reinterpret_cast<int*>(work + words + 2 * s.rows * s.cols);
    words += 3 * s.rows * s.cols;
  }
  if (words == 0) return 0;
  err = cudaMemsetAsync(work, 0, words * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    for (int k = 0; k < a.count; ++k) a.s[k].blocks = blocks_for(n);
    const unsigned grid = static_cast<unsigned>(a.count * blocks_for(n));
    row_exponent_kernel<T><<<grid, kThreads, 0, st>>>(a);
    row_accumulate_kernel<T><<<grid, kThreads, 0, st>>>(a);
  }
  int64_t blocks = 0;
  for (int k = 0; k < a.count; ++k)
    blocks += a.s[k].blocks = blocks_for(a.s[k].rows * a.s[k].cols);
  row_round_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K16 on `stream` over n rays: for each of the `count` segments
// of the host array desc (five int64 each: a table's device pointer, its
// (n,) int64 indices', the (n, cols) output's, rows, cols), out = table[
// idx] row by row.
int frt_gather_rows_f32(const int64_t* desc, int count, int64_t n,
                        void* stream) {
  return gather<float>(desc, count, n, stream);
}

int frt_gather_rows_f64(const int64_t* desc, int count, int64_t n,
                        void* stream) {
  return gather<double>(desc, count, n, stream);
}

// Launches K17 on `stream` over n rays: for each segment of desc (the (n,
// cols) gradient, its indices, the (rows, cols) output, rows, cols), out =
// the sum of the gradient's rows by index (module comment); work holds 3
// rows cols int64 summed over the segments and is zeroed here; n < 2^31.
int frt_row_sum_f32(const int64_t* desc, int count, int64_t n,
                    int64_t* work, void* stream) {
  return row_sum<float>(desc, count, n, work, stream);
}

int frt_row_sum_f64(const int64_t* desc, int count, int64_t n,
                    int64_t* work, void* stream) {
  return row_sum<double>(desc, count, n, work, stream);
}

}  // extern "C"
