// K1, K2 and K2b on Hopper: the whole forward path tracer in one CUDA
// kernel, the same kernel writing the winner tape of the differentiable
// pass, and the standalone tape recorder.
//
// K1 (`mega_kernel<false>`) replaces
// first_raytracer_tpu/kernels/megakernel.py:306 _mega_kernel, the
// persistent-lane Pallas megakernel of the JAX package.  It computes the same
// thing: for every pixel, `spp` camera samples traced to termination through
// a dense sweep of every sphere and triangle, with the same counter-based
// Threefry-2x32-20 stream (bit-identical uniforms), exact (min t, lowest
// sorted index) closest-hit selection, lambertian / metal / dielectric
// scatter with the checker texture, the sky on a miss, and a per-pixel
// radiance sum plus a per-pixel segment count.
//
// K2 (`mega_kernel<true>`) replaces the same Pallas kernel with
// `emit_tape=True`, as first_raytracer_tpu/kernels/record_mega.py:522
// _record_mega2 launches it.  It is K1 plus an int32 tape (D, num_pixels *
// spp), D = max_depth + 1: column loc * spp + s belongs to sample s of local
// pixel loc, and row d holds the original scene id of the primitive that
// sample's path hit at bounce d (spheres 0..Ns-1, triangles Ns + j, read from
// payload row 13 / 20), or -1 on a miss, after the path ended, or for a pixel
// past the image.  Every row of every column is written, so the caller
// allocates the tape without filling it.  The TPU kernel's id + 1 float
// encoding and its (s * D + d, lane) block relayout are layout devices of the
// TPU and have no counterpart here; neither does its VMEM spp batching: one
// launch covers all samples.
//
// K2b (`record_kernel`) replaces first_raytracer_tpu/kernels/record_mega.py:62
// _record_kernel, the Pallas recorder that the JAX package reaches through
// record_paths_mega(impl="legacy") or return_iters=True; the port's
// record_paths_mega records every dense tape with it.  For every ray id in
// [ray0, ray0 + R) it records the path that K1 traces for that id (pixel
// rid / spp_total, sample rid % spp_total) as a column of the same tape
// (D, R), and writes the ray's bounce-loop trip count (its segment count).
// The TPU kernel counts trips per tile of lanes, a number that depends on its
// schedule; the per-ray count here does not.  One thread per ray id, tracing
// with the radiance work compiled out, so its tape equals K2's over the same
// ids.  The pixel comes from integer division: the TPU kernel's
// float-reciprocal division (_fdiv / _fdiv_exact), grid-stride lanes, rays
// per lane and one-hot tape accumulation have no counterpart here.
//
// Mapping of K1 and K2: one thread per pixel.  The thread loops over the pixel's samples
// in order, traces each to termination with ordinary per-thread control
// flow (mega_common.cuh::trace_path), and writes its pixel and its own tape
// columns, so there are no atomics and the output does not depend on the
// schedule.  The TPU kernel's grid-stride lanes, pixels-per-lane,
// channel-major flush and unrolling are TPU scheduling devices and have no
// counterpart here.
//
// What bounds it on an H100:
//  - FP32 ALU work in the dense sweep: 16 flops per (segment, sphere) and
//    46 per (segment, triangle), counted from closest_hit.  The final scene
//    has 486 spheres, so each segment costs ~7.8e3 flops before any shading.
//  - Divergence across a warp's paths: a warp runs until its longest path
//    ends (glass paths reach tens of bounces while most end in two or
//    three), and the material branches split the warp at each hit.
//  - K2's tape adds D * 4 bytes per sample: 51 x 9.6 M x 4 B = 1.96 GB at
//    full frame, ~0.6 ms at 3.35 TB/s, far below the sweep's time, so K2
//    stays compute-bound.  K2b has the same sweep and tape per ray; at the
//    fit step's 2^17 rays its tape is 27 MB, 8 us.
// This first design does nothing about either beyond one thread per pixel
// (K2b: per ray, whose neighbouring threads write neighbouring columns):
// the tables are read from global memory through the read-only cache, and
// since every thread of a warp reads the same primitive at the same step,
// each read is a broadcast.  K2's tape columns sit at stride `spp` between
// neighbouring threads, so its stores are not coalesced; that too is left
// to later work, with staging the tables in shared memory, culling, and
// regrouping paths.
#include "mega_common.cuh"

namespace {

using frt::CameraRow;
using frt::DenseScene;
using frt::PathParams;

constexpr int kThreads = 128;

struct Launch {
  int spp;
  int spp_total;   // samples per pixel of the whole render (ray id space)
  int spp0;        // first sample of this launch
  int pix0;        // global id of local pixel 0
  int num_pixels;  // pixels of this launch
  int total_pixels;
};

// At most 64 registers, so that eight blocks fit an SM: left to itself,
// ptxas gives the shared trace 72 and K1 loses occupancy and time.
template <bool kTape>
__global__ void __launch_bounds__(kThreads, 8)
    mega_kernel(const DenseScene scene, const PathParams pp, const Launch ln,
                float* __restrict__ rad, int* __restrict__ segs,
                int* __restrict__ tape) {
  const int loc = blockIdx.x * blockDim.x + threadIdx.x;
  if (loc >= ln.num_pixels) return;
  const int pix = ln.pix0 + loc;
  // Tape column of sample s: loc * spp + s; rows at stride num_pixels * spp.
  const size_t stride = static_cast<size_t>(ln.num_pixels) * ln.spp;
  int* col = kTape ? tape + static_cast<size_t>(loc) * ln.spp : nullptr;
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  int nseg = 0;
  if (pix < ln.total_pixels) {
    const CameraRow cam = frt::load_camera(scene.tb.cam);
    const float fi = static_cast<float>(pix % pp.nx);
    const float fj = static_cast<float>(pix / pp.nx);  // bottom-up row
    DenseScene::Counters cnt;
    for (int s = 0; s < ln.spp; ++s) {
      const uint32_t rid = static_cast<uint32_t>(pix) *
                               static_cast<uint32_t>(ln.spp_total) +
                           static_cast<uint32_t>(ln.spp0 + s);
      nseg += frt::trace_path<true, kTape>(scene, cnt, cam, pp, rid, fi, fj,
                                           sum_r, sum_g, sum_b,
                                           kTape ? col + s : nullptr, stride);
    }
  } else if (kTape) {
    for (int s = 0; s < ln.spp; ++s) {
      for (int d = 0; d <= pp.max_depth; ++d) col[d * stride + s] = -1;
    }
  }
  rad[3 * loc + 0] = sum_r;
  rad[3 * loc + 1] = sum_g;
  rad[3 * loc + 2] = sum_b;
  segs[loc] = nseg;
}

__global__ void __launch_bounds__(kThreads)
    record_kernel(const DenseScene scene, const PathParams pp, int ray0,
                  int num_rays, int spp_total, int* __restrict__ tape,
                  int* __restrict__ its) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const int rid = ray0 + i;
  const int pix = rid / spp_total;
  const CameraRow cam = frt::load_camera(scene.tb.cam);
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;  // unused: no radiance
  DenseScene::Counters cnt;
  its[i] = frt::trace_path<false, true>(
      scene, cnt, cam, pp, static_cast<uint32_t>(rid),
      static_cast<float>(pix % pp.nx), static_cast<float>(pix / pp.nx),
      sum_r, sum_g, sum_b, tape + i, static_cast<size_t>(num_rays));
}

}  // namespace

extern "C" {

// Launches K1 (tape == nullptr) or K2 on `stream` over `num_pixels` pixels
// starting at global pixel `pix0`; writes rad (num_pixels, 3) f32, segs
// (num_pixels,) i32 and, for K2, tape (max_depth + 1, num_pixels * spp) i32.
// `groups` is a host array: the 7 sphere group starts, then the 7 triangle
// ones.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_mega_render(const float* cam, const float* sph, const float* mx,
                    const float* tri, int ns, int nt, int ns_pad, int nt_pad,
                    const int* groups, unsigned int k0, unsigned int k1,
                    int nx, int ny, int spp, int spp_total, int spp0,
                    int pix0, int num_pixels, int total_pixels,
                    int max_depth, float t_min, float* rad, int* segs,
                    int* tape, void* stream) {
  const DenseScene scene{
      frt::make_tables(cam, sph, mx, tri, ns, nt, ns_pad, nt_pad, groups)};
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const Launch ln{spp, spp_total, spp0, pix0, num_pixels, total_pixels};
  if (num_pixels > 0) {
    const int blocks = (num_pixels + kThreads - 1) / kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tape != nullptr) {
      mega_kernel<true><<<blocks, kThreads, 0, st>>>(scene, pp, ln, rad,
                                                     segs, tape);
    } else {
      mega_kernel<false><<<blocks, kThreads, 0, st>>>(scene, pp, ln, rad,
                                                      segs, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2b on `stream` over ray ids [ray0, ray0 + num_rays); writes tape
// (max_depth + 1, num_rays) i32 and its (num_rays,) i32.  `groups` as for
// frt_mega_render.  Returns cudaGetLastError() after the launch.
int frt_record_paths(const float* cam, const float* sph, const float* mx,
                     const float* tri, int ns, int nt, int ns_pad,
                     int nt_pad, const int* groups, unsigned int k0,
                     unsigned int k1, int nx, int ny, int spp_total,
                     int ray0, int num_rays, int max_depth, float t_min,
                     int* tape, int* its, void* stream) {
  const DenseScene scene{
      frt::make_tables(cam, sph, mx, tri, ns, nt, ns_pad, nt_pad, groups)};
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    record_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scene, pp, ray0, num_rays, spp_total, tape, its);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
