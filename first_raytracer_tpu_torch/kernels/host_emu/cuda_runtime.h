// A stand-in for <cuda_runtime.h> that lets g++ compile the package's CUDA
// sources (kernels/csrc) into a host library, for the CPU tests of
// tests/test_torch_cuda_host.py and test_torch_bvh_walk.py: the kernels'
// own code, run on the host, held bit for bit against their plain PyTorch
// versions.  Nothing of the package's entry points loads it; the card runs
// the real sources.
//
// A launch `k<<<grid, block, smem, stream>>>(args);` is rewritten by
// host_emu/build.py into frt_emu::launch(grid, block, smem, [&] { k(args);
// }): the blocks run one after another, each CUDA thread of a block as a
// fiber of its own (ucontext) on the calling thread, so __syncthreads is a
// barrier of the block and a warp's collectives (ballot, shuffles,
// __syncwarp) a barrier of its 32 threads with an exchange buffer between
// two waits.  A fiber runs until it waits at a barrier or returns, then
// the block's scheduler resumes the next one, in thread order; a barrier
// opens when its last thread arrives.  One OS thread runs the whole block,
// so a launch costs no thread starts and its barriers never wait on the
// host's scheduler, however busy the host is.  The kernels call the
// collectives only where the whole warp is converged, as on the card.  A
// thread that returns leaves both barriers.  `extern __shared__` becomes
// the block's buffer, which the launcher fills with garbage; cp.async
// (csrc/cp_async.cuh) is replaced by a synchronous copy.  Build with g++
// -std=c++20 -ffp-contract=off, so that no product is fused where nvcc
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

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

using cudaStream_t = void*;
using cudaError_t = int;
constexpr cudaError_t cudaSuccess = 0;
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
#define sqrtf frt_emu_sqrtf
#define sinf frt_emu_sinf
#define cosf frt_emu_cosf

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
inline int __ffs(int x) { return __builtin_ffs(x); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

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

// Runs `body` as the kernel: `grid` blocks in turn, `block` threads each,
// every thread a fiber on the calling thread.
template <class F>
void launch(dim3 grid, dim3 block, size_t smem_bytes, F body) {
  const int nthreads = static_cast<int>(block.x * block.y * block.z);
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  std::vector<unsigned char> smem(smem_bytes + 16);
  // The fibers' stacks, touched only as deep as they grow.
  const size_t bytes = kStack * static_cast<size_t>(nthreads);
  void* stacks = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) {
    std::fprintf(stderr, "frt_emu: no memory for %d fiber stacks\n",
                 nthreads);
    std::abort();
  }
  tl_body = &body;
  tl_dim = block;
  tl_grid = grid;
  tl_smem = smem.data();
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    // Garbage in shared memory, as a kernel may find it.
    for (size_t i = 0; i < smem.size(); ++i)
      smem[i] = static_cast<unsigned char>(0xA5 ^ (i * 131 + bx));
    Block st;
    st.all.expected = nthreads;
    st.warps.resize(nwarps);
    for (int w = 0; w < nwarps; ++w)
      st.warps[w].expected = std::min(kWarp, nthreads - w * kWarp);
    st.exchange.assign(nthreads, 0);
    st.fibers.resize(nthreads);
    st.done.assign(nthreads, 0);
    tl_state = &st;
    tl_block = dim3(bx);
    for (int t = 0; t < nthreads; ++t) {
      ucontext_t& c = st.fibers[t];
      getcontext(&c);
      c.uc_stack.ss_sp = static_cast<char*>(stacks) + kStack * t;
      c.uc_stack.ss_size = kStack;
      c.uc_link = &st.scheduler;
      makecontext(&c, &fiber_main<F>, 0);
    }
    for (int left = nthreads; left > 0;) {
      const unsigned long before = st.progress;
      for (int t = 0; t < nthreads; ++t) {
        if (st.done[t]) continue;
        st.current = t;
        tl_thread = dim3(t);
        swapcontext(&st.scheduler, &st.fibers[t]);
        left -= st.done[t];
      }
      if (left > 0 && st.progress == before) {
        std::fprintf(stderr, "frt_emu: block %u deadlocked at a barrier\n",
                     bx);
        std::abort();
      }
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
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  T all[frt_emu::kWarp];
  frt_emu::exchange<T>(v, all);
  return all[(frt_emu::flat_thread() % frt_emu::kWarp) ^ lane_mask];
}
