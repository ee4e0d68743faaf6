// The host emulation's cp_async.cuh (host_emu/cuda_runtime.h): each copy
// is done when it is issued, so committing and waiting do nothing.
#pragma once

#include <cuda_runtime.h>

namespace frt {

inline void copy16_async(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 16);
}
inline void copy4_async(void* smem, const void* gmem) {
  std::memcpy(smem, gmem, 4);
}
inline void commit_copies() {}
template <int N>
inline void wait_copies() {}

}  // namespace frt
