// A stand-in for <cuda_runtime.h> that lets g++ compile the package's CUDA
// sources (kernels/csrc) into a host library, for the CPU tests of
// tests/test_torch_cuda_host.py: the kernels' own code, run on the host,
// held bit for bit against their plain PyTorch versions.  Nothing of the
// package's entry points loads it; the card runs the real sources.
//
// A launch `k<<<grid, block, smem, stream>>>(args);` is rewritten by
// host_emu/build.py into frt_emu::launch(grid, block, smem, [&] { k(args);
// }): the blocks run one after another, each CUDA thread of a block on a
// std::thread of its own, so __syncthreads is a barrier of the block and a
// warp's collectives (ballot, shuffles, __syncwarp) a barrier of its 32
// threads with an exchange buffer between two waits.  The kernels call
// those only where the whole warp is converged, as on the card.  A thread
// that returns leaves both barriers.  `extern __shared__` becomes the
// block's buffer, which the launcher fills with garbage; cp.async (csrc/
// cp_async.cuh) is replaced by a synchronous copy.  Build with g++
// -std=c++20 -pthread -ffp-contract=off, so that no product is fused where
// nvcc --fmad=false would not fuse it.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
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

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

namespace frt_emu {

constexpr int kWarp = 32;

struct Block {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> exchange;  // one slot per thread of the block
};

inline thread_local dim3 tl_thread, tl_block, tl_dim, tl_grid;
inline thread_local Block* tl_state = nullptr;
inline thread_local unsigned char* tl_smem = nullptr;

}  // namespace frt_emu

#define threadIdx (frt_emu::tl_thread)
#define blockIdx (frt_emu::tl_block)
#define blockDim (frt_emu::tl_dim)
#define gridDim (frt_emu::tl_grid)

namespace frt_emu {

inline int flat_thread() { return static_cast<int>(tl_thread.x); }
inline std::barrier<>& warp_barrier() {
  return *tl_state->warps[flat_thread() / kWarp];
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
  warp_barrier().arrive_and_wait();
  const int w0 = t / kWarp * kWarp;
  for (int l = 0; l < kWarp; ++l)
    std::memcpy(&out[l], &tl_state->exchange[w0 + l], sizeof(T));
  warp_barrier().arrive_and_wait();
}

// Runs `body` as the kernel: `grid` blocks in turn, `block` threads each.
template <class F>
void launch(dim3 grid, dim3 block, size_t smem_bytes, F body) {
  const int nthreads = static_cast<int>(block.x * block.y * block.z);
  const int nwarps = (nthreads + kWarp - 1) / kWarp;
  std::vector<unsigned char> smem(smem_bytes + 16);
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    // Garbage in shared memory, as a kernel may find it.
    for (size_t i = 0; i < smem.size(); ++i)
      smem[i] = static_cast<unsigned char>(0xA5 ^ (i * 131 + bx));
    Block st;
    st.all = std::make_unique<std::barrier<>>(nthreads);
    for (int w = 0; w < nwarps; ++w)
      st.warps.push_back(std::make_unique<std::barrier<>>(
          std::min(kWarp, nthreads - w * kWarp)));
    st.exchange.assign(nthreads, 0);
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t, bx] {
        tl_thread = dim3(t);
        tl_block = dim3(bx);
        tl_dim = block;
        tl_grid = grid;
        tl_state = &st;
        tl_smem = smem.data();
        body();
        st.warps[t / kWarp]->arrive_and_drop();
        st.all->arrive_and_drop();
      });
    }
    for (auto& th : threads) th.join();
  }
}

}  // namespace frt_emu

inline void __syncthreads() { frt_emu::tl_state->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  frt_emu::warp_barrier().arrive_and_wait();
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
