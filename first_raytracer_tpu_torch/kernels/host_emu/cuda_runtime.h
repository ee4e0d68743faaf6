// A stand-in for <cuda_runtime.h> that lets g++ compile the package's CUDA
// sources (kernels/csrc) into a host library, for the CPU tests of
// tests/test_torch_cuda_host.py, test_torch_bvh_walk.py and
// test_torch_wavefront_pass.py: the kernels' own code, run on the host,
// held bit for bit against their plain PyTorch versions.  Nothing of the
// package's entry points loads it; the card runs the real sources.
//
// A launch `k<<<grid, block, smem, stream>>>(args);` is rewritten by
// host_emu/build.py into frt_emu::launch(grid, block, smem, [&] { k(args);
// }): each CUDA thread of a block runs as a fiber of its own (ucontext) on
// the calling thread, so __syncthreads is a barrier of the block and a
// warp's collectives (ballot, shuffles, __syncwarp) a barrier of its 32
// threads with an exchange buffer between two waits.  A fiber runs until
// it waits at a barrier, spins (__nanosleep) or returns, then the
// scheduler resumes the next one; a barrier opens when its last thread
// arrives.  One OS thread runs the whole launch, so a launch costs no
// thread starts and its barriers never wait on the host's scheduler,
// however busy the host is.  The kernels call the collectives only where
// the whole warp is converged, as on the card.  A thread that returns
// leaves both barriers.
//
// Blocks run one after another by default.  frt_emu_interleave(resident,
// seed) (the library's own entry point, from host_emu/build.py) makes the
// launches that follow keep `resident` blocks in flight at once, as a card
// of that many resident blocks would (this shim reports 2 multiprocessors
// of 2 blocks: 4), started in blockIdx order as others finish, their
// fibers swept in an order of the blocks drawn from `seed` anew each
// sweep: a block that waits on another (a look-back's spin) sees it at any
// stage.  Static __shared__ variables are one per kernel for every block,
// so a kernel run interleaved keeps its shared memory in `extern
// __shared__`, the block's own buffer, which the launcher fills with
// garbage.  cp.async (csrc/cp_async.cuh) is replaced by a synchronous
// copy.  Memory is sequentially consistent here: __threadfence is a no-op,
// and races between warps between two switches cannot show.  Build with
// g++ -std=c++20 -ffp-contract=off, so that no product is fused where nvcc
// --fmad=false would not fuse it.
#pragma once

#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define FRT_HOST_EMU 1  // a kernel may note what it met for the tests
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

using cudaStream_t = void*;
using cudaError_t = int;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// A small card: two multiprocessors of two blocks each, so that a
// persistent launch runs a few blocks that share the work.
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F,
                                                                 int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

using std::max;
using std::min;

// sqrtf, sinf and cosf in double, rounded once: the plain versions compute
// them so on the CPU (core/vecmath.py), where torch's float32 ones are an
// ulp off on a fraction of inputs, and so does CUDA's sqrtf; the host
// libm's sinf and cosf are within an ulp, not always rounded correctly.
inline float frt_emu_sqrtf(float x) {
  return static_cast<float>(std::sqrt(static_cast<double>(x)));
}
inline float frt_emu_sinf(float x) {
  return static_cast<float>(std::sin(static_cast<double>(x)));
}
inline float frt_emu_cosf(float x) {
  return static_cast<float>(std::cos(static_cast<double>(x)));
}
// One range reduction on the card; rounded here as sinf and cosf are.
inline void frt_emu_sincosf(float x, float* s, float* c) {
  *s = frt_emu_sinf(x);
  *c = frt_emu_cosf(x);
}
#define sqrtf frt_emu_sqrtf
#define sinf frt_emu_sinf
#define cosf frt_emu_cosf
#define sincosf frt_emu_sincosf

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// Reinterpretations of a 32-bit word, as the card's intrinsics.
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline int __float_as_int(float x) {
  int i;
  std::memcpy(&i, &x, sizeof i);
  return i;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
// The high 32 bits of the 64-bit product.
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<uint64_t>(a) * b) >> 32);
}
inline int __ffs(int x) { return __builtin_ffs(x); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
// A fiber is never switched inside an add: a plain one is atomic here.
inline double atomicAdd(double* p, double v) {
  const double old = *p;
  *p = old + v;
  return old;
}
// Writes v where *p is cmp; returns what *p was (a plain one, as above).
inline unsigned long long atomicCAS(unsigned long long* p,
                                    unsigned long long cmp,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  if (old == cmp) *p = v;
  return old;
}
inline int atomicMax(int* p, int v) {
  const int old = *p;
  if (v > old) *p = v;
  return old;
}
inline int atomicOr(int* p, int v) {
  const int old = *p;
  *p = old | v;
  return old;
}
inline void __threadfence() {}

// Reinterpretations and conversions of 64-bit values, rounded to nearest
// even as the card's _rn intrinsics round (the host's default mode).
inline long long __double_as_longlong(double x) {
  long long i;
  std::memcpy(&i, &x, sizeof i);
  return i;
}
inline double __longlong_as_double(long long x) {
  double d;
  std::memcpy(&d, &x, sizeof d);
  return d;
}
inline long long __double2ll_rn(double x) { return std::llrint(x); }
inline double __ll2double_rn(long long x) { return static_cast<double>(x); }
inline float __double2float_rn(double x) { return static_cast<float>(x); }

namespace frt_emu {

constexpr int kWarp = 32;
constexpr size_t kStack = 512 * 1024;  // each fiber's stack

// A barrier of a block's fibers: the last of `expected` to arrive opens
// the phase; the others give the processor back until it has opened.
struct Barrier {
  int expected = 0;
  int arrived = 0;
  unsigned long phase = 0;
};

struct Block {
  unsigned index = 0;               // blockIdx.x
  std::vector<unsigned char> smem;  // its dynamic shared memory
  Barrier all;
  std::vector<Barrier> warps;
  std::vector<uint64_t> exchange;  // one slot per thread of the block
  std::vector<ucontext_t> fibers;  // one per thread of the block
  std::vector<char> done;
  ucontext_t scheduler;
  int current = 0;
  unsigned long progress = 0;  // arrivals and returns: a deadlock makes none
};

inline thread_local dim3 tl_thread, tl_block, tl_dim, tl_grid;
inline thread_local Block* tl_state = nullptr;
inline thread_local unsigned char* tl_smem = nullptr;
inline thread_local void* tl_body = nullptr;  // the launch's kernel call

// frt_emu_interleave's settings: resident blocks (0: one after another)
// and the seed of the sweeps' orders; the spins (__nanosleep calls) since.
struct Schedule {
  int resident = 0;
  unsigned long long seed = 0;
  unsigned long long spins = 0;
  unsigned long long launch_spins = 0;  // the current launch's
  // What look-backs met (wavefront_pass.cu notes them): windows of status
  // words read, those with no inclusive prefix in them (the look-back went
  // on past them), and aggregates summed.
  unsigned long long windows = 0, crossings = 0, aggregates = 0;
};
inline Schedule schedule;
inline void note_window(int aggregates, bool crossed) {
  ++schedule.windows;
  schedule.crossings += crossed;
  schedule.aggregates += aggregates;
}
// A launch that spins this often without ending is stuck.
constexpr unsigned long long kMaxSpins = 1ull << 26;

}  // namespace frt_emu

#define threadIdx (frt_emu::tl_thread)
#define blockIdx (frt_emu::tl_block)
#define blockDim (frt_emu::tl_dim)
#define gridDim (frt_emu::tl_grid)

namespace frt_emu {

inline int flat_thread() { return static_cast<int>(tl_thread.x); }

// Gives the processor back to the block's scheduler.
inline void yield() {
  Block& b = *tl_state;
  swapcontext(&b.fibers[b.current], &b.scheduler);
}

inline void open(Barrier& br) {
  br.arrived = 0;
  ++br.phase;
}

inline void arrive_and_wait(Barrier& br) {
  ++tl_state->progress;
  if (++br.arrived == br.expected) {
    open(br);
    return;
  }
  const unsigned long phase = br.phase;
  while (br.phase == phase) yield();
}

// A returning thread counts as arrived in this phase and is not expected
// in later ones (std::barrier::arrive_and_drop).
inline void arrive_and_drop(Barrier& br) {
  --br.expected;
  if (br.expected > 0 && br.arrived == br.expected) open(br);
}

inline Barrier& warp_barrier() {
  return tl_state->warps[flat_thread() / kWarp];
}

// Every lane of the calling thread's warp publishes `v`; returns the
// 32 values, read after every lane has written.
template <class T>
inline void exchange(T v, T (&out)[kWarp]) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const int t = flat_thread();
  uint64_t slot = 0;
  std::memcpy(&slot, &v, sizeof(T));
  tl_state->exchange[t] = slot;
  arrive_and_wait(warp_barrier());
  const int w0 = t / kWarp * kWarp;
  for (int l = 0; l < kWarp; ++l)
    std::memcpy(&out[l], &tl_state->exchange[w0 + l], sizeof(T));
  arrive_and_wait(warp_barrier());
}

// A fiber's life: the kernel call, then it leaves both barriers and
// returns to the scheduler (its context's uc_link).
template <class F>
void fiber_main() {
  (*static_cast<F*>(tl_body))();
  Block& b = *tl_state;
  arrive_and_drop(b.warps[flat_thread() / kWarp]);
  arrive_and_drop(b.all);
  b.done[b.current] = 1;
  ++b.progress;
}

// A spinning thread gives the processor back (__nanosleep).
inline void spin() {
  ++schedule.spins;
  if (++schedule.launch_spins == kMaxSpins) {
    std::fprintf(stderr, "frt_emu: a launch spun %llu times\n",
                 schedule.launch_spins);
    std::abort();
  }
  yield();
}

// xorshift64*: the sweeps' orders.
inline unsigned long long next_random(unsigned long long& x) {
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  return x * 2685821657736338717ull;
}

// Makes block `index`'s fibers, on the stacks at `stacks`.
template <class F>
void start_block(Block& st, unsigned index, int nthreads, size_t smem_bytes,
                 char* stacks) {
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  st.index = index;
  // Garbage in shared memory, as a kernel may find it.
  st.smem.resize(smem_bytes + 16);
  for (size_t i = 0; i < st.smem.size(); ++i)
    st.smem[i] = static_cast<unsigned char>(0xA5 ^ (i * 131 + index));
  st.all.expected = nthreads;
  st.warps.assign(nwarps, Barrier{});
  for (int w = 0; w < nwarps; ++w)
    st.warps[w].expected = std::min(kWarp, nthreads - w * kWarp);
  st.exchange.assign(nthreads, 0);
  st.fibers.resize(nthreads);
  st.done.assign(nthreads, 0);
  for (int t = 0; t < nthreads; ++t) {
    ucontext_t& c = st.fibers[t];
    getcontext(&c);
    c.uc_stack.ss_sp = stacks + kStack * t;
    c.uc_stack.ss_size = kStack;
    c.uc_link = &st.scheduler;
    makecontext(&c, &fiber_main<F>, 0);
  }
}

// One sweep of a block: each of its fibers that has not returned runs
// until it next gives the processor back.  Returns the fibers left.
inline int sweep(Block& st, int nthreads) {
  tl_state = &st;
  tl_block = dim3(st.index);
  tl_smem = st.smem.data();
  int left = 0;
  for (int t = 0; t < nthreads; ++t) {
    if (st.done[t]) continue;
    st.current = t;
    tl_thread = dim3(t);
    swapcontext(&st.scheduler, &st.fibers[t]);
    left += !st.done[t];
  }
  return left;
}

// Runs `body` as the kernel: `grid` blocks, `block` threads each, every
// thread a fiber on the calling thread; schedule.resident blocks at once
// (one when 0).
template <class F>
void launch(dim3 grid, dim3 block, size_t smem_bytes, F body) {
  const int nthreads = static_cast<int>(block.x * block.y * block.z);
  const int resident = std::max(1, schedule.resident);
  // The fibers' stacks, touched only as deep as they grow.
  const size_t per_block = kStack * static_cast<size_t>(nthreads);
  const size_t bytes = per_block * resident;
  void* stacks = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) {
    std::fprintf(stderr, "frt_emu: no memory for %d fiber stacks\n",
                 nthreads * resident);
    std::abort();
  }
  tl_body = &body;
  tl_dim = block;
  tl_grid = grid;
  schedule.launch_spins = 0;
  std::vector<Block> slots(resident);
  std::vector<char> busy(resident, 0);
  std::vector<int> order(resident);
  unsigned long long random = schedule.seed * 0x9E3779B97F4A7C15ull + 1;
  for (unsigned next = 0;;) {
    for (int s = 0; s < resident; ++s)
      if (!busy[s] && next < grid.x) {
        start_block<F>(slots[s], next++, nthreads, smem_bytes,
                       static_cast<char*>(stacks) + per_block * s);
        busy[s] = 1;
      }
    int running = 0;
    for (int s = 0; s < resident; ++s)
      if (busy[s]) order[running++] = s;
    if (running == 0) break;
    for (int k = running - 1; k > 0 && schedule.resident > 0; --k)
      std::swap(order[k], order[next_random(random) % (k + 1)]);
    unsigned long long before = 0, after = 0;
    for (int s = 0; s < resident; ++s) before += slots[s].progress;
    for (int k = 0; k < running; ++k) {
      const int s = order[k];
      busy[s] = sweep(slots[s], nthreads) > 0;
    }
    for (int s = 0; s < resident; ++s) after += slots[s].progress;
    if (after == before) {
      std::fprintf(stderr, "frt_emu: blocks deadlocked at a barrier\n");
      std::abort();
    }
  }
  tl_state = nullptr;
  munmap(stacks, bytes);
}

}  // namespace frt_emu

inline void __syncthreads() {
  frt_emu::arrive_and_wait(frt_emu::tl_state->all);
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  frt_emu::arrive_and_wait(frt_emu::warp_barrier());
}
inline void __nanosleep(unsigned) { frt_emu::spin(); }

inline unsigned __ballot_sync(unsigned mask, int pred) {
  int v[frt_emu::kWarp];
  frt_emu::exchange<int>(pred != 0, v);
  unsigned out = 0;
  for (int l = 0; l < frt_emu::kWarp; ++l)
    if (v[l] && ((mask >> l) & 1u)) out |= 1u << l;
  return out;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline int __all_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) == mask;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  T all[frt_emu::kWarp];
  frt_emu::exchange<T>(v, all);
  return all[src & (frt_emu::kWarp - 1)];
}
// The lanes of `mask` whose `v` equals the calling lane's.
template <class T>
inline unsigned __match_any_sync(unsigned mask, T v) {
  T all[frt_emu::kWarp];
  frt_emu::exchange<T>(v, all);
  unsigned out = 0;
  for (int l = 0; l < frt_emu::kWarp; ++l)
    if (((mask >> l) & 1u) && all[l] == v) out |= 1u << l;
  return out;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  T all[frt_emu::kWarp];
  frt_emu::exchange<T>(v, all);
  return all[(frt_emu::flat_thread() % frt_emu::kWarp) ^ lane_mask];
}

// The library's control of the emulation (host_emu/build.py compiles this
// part once, with FRT_EMU_CONTROL defined): resident blocks and the seed
// of the sweeps' orders for the launches that follow (resets the spins);
// the spins since; what look-backs met since (windows, crossings,
// aggregates).
#if defined(FRT_EMU_CONTROL)
extern "C" void frt_emu_interleave(int resident, unsigned long long seed) {
  frt_emu::schedule = frt_emu::Schedule{};
  frt_emu::schedule.resident = resident;
  frt_emu::schedule.seed = seed;
}
extern "C" unsigned long long frt_emu_spins() {
  return frt_emu::schedule.spins;
}
extern "C" void frt_emu_look_backs(unsigned long long* out) {
  out[0] = frt_emu::schedule.windows;
  out[1] = frt_emu::schedule.crossings;
  out[2] = frt_emu::schedule.aggregates;
}
#endif
