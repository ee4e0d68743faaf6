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
// schedule; the per-ray count here does not.  It traces with the radiance
// work compiled out, so its tape equals K2's over the same ids.  The pixel
// comes from integer division: the TPU kernel's float-reciprocal division
// (_fdiv / _fdiv_exact), grid-stride lanes, rays per lane and one-hot tape
// accumulation have no counterpart here.
//
// Mapping (this design is Hopper's, not the TPU kernel's).  Each block of
// 128 threads first stages the scene's sphere rows (cx, cy, cz, r) and
// triangle planes (v0, e1, e2) in shared memory with cp.async: the final
// scene's 486 spheres take 7.8 KB, DENSE_MAX = 1024 spheres 16 KB; a scene
// past kSphereCap spheres or kTriCap triangles reads the rest from device
// memory after the staged rows.  Every launch is persistent (as many blocks
// as the card holds at once).  K1's and K2's warps take groups of 32 pixels
// from a launch-wide counter (mega_common.cuh::render_warp): a lane whose
// path ends takes the next unstarted (pixel, sample) of its warp's window
// of work at a point where the whole warp is converged, and each pixel is
// summed in sample order from the warp's shared store, so the output does
// not depend on the schedule and equals the plain version's bit for bit.
// K2b's warps take windows of consecutive ray ids the same way
// (mega_common.cuh::record_warp), each ray writing its own tape column.
// All three sweep with the whole warp (DenseScene::closest): with k paths
// live, each live ray's spheres and triangles are split over 32 / k lanes.
// The gradient step records 2^17 rays, about the card's resident lanes, so
// regeneration has few ids to hand out there, and the launch would end
// when its deepest path (up to 51 segments) had swept the scene serially on
// one lane while 31 idled; split, that path's segments take a 32nd of the
// sweep.
//
// What bounds it on an H100, and what the design does about it:
//  - FP32 work in the dense sweep: 20 operations per (segment, sphere) and
//    46 per (segment, triangle).  Built with --fmad=false, each is one
//    instruction, so everything around them counts: a pair reads one
//    16-byte shared-memory broadcast (the first design read the row from
//    device memory through the read-only cache), and a group of four
//    spheres shares one branch to the rare root, so a miss costs the 20
//    operations of the float prefilter and a compare (the first design
//    took a branch per sphere: ~56 issue slots a pair on the final scene,
//    PERF.md).  The root is taken in double (mega_common.cuh::
//    sphere_group), at half the float rate with conversions at an eighth
//    of it, but only by the spheres past the prefilter.
//  - Divergence across a warp's paths: glass paths reach tens of bounces
//    while most end in two or three.  With one thread per pixel a warp ran
//    until its busiest pixel's samples were done (lane efficiency 0.685 on
//    the final scene); regeneration over a window of work keeps the lanes
//    busy until the launch runs out of paths.
//  - No tensor cores: the dot products C.d and C.o per (ray, sphere) would
//    map to a (rays x 3) x (3 x spheres) product, but TF32 or bf16 inputs do
//    not round as the f32 products do, and the root is taken in double;
//    the kernel must stay bit-equal to its plain version.
//  - K2's and K2b's tapes add D * 4 bytes per sample: 51 x 9.6 M x 4 B =
//    1.96 GB at full frame, ~0.6 ms at 3.35 TB/s, far below the sweep's
//    time.  K2's columns sit at stride spp between a pixel's samples, and
//    K2b's regenerating lanes write scattered columns, so neither's stores
//    are coalesced; the L2 cache merges them.
#include "mega_common.cuh"

namespace {

using frt::CameraRow;
using frt::DenseScene;
using frt::PathParams;
using frt::RecordLaunch;
using frt::RenderLaunch;

constexpr int kThreads = frt::kRenderThreads;
// Samples of a pixel in a unit of a warp's work (its window holds two
// units); a render of more samples per pixel takes them in chunks of this
// many.  8: K1 took 11.2 ms on the final scene against 11.5 at 4 and 12.7
// at 2 (probes/mega_grid.py, PERF.md).
constexpr int kMaxChunk = 8;

int chunk_of(int spp) { return spp < kMaxChunk ? spp : kMaxChunk; }

int render_smem_bytes(int ns, int nt, int chunk) {
  return DenseScene::smem_bytes(ns, nt) +
         frt::kRenderWarps * frt::warp_store_bytes(chunk, 0);
}

// At most 64 registers, so that eight blocks fit an SM.
template <bool kTape>
__global__ void __launch_bounds__(kThreads, 8)
    mega_kernel(const DenseScene scene, const PathParams pp,
                const RenderLaunch ln, float* __restrict__ rad,
                int* __restrict__ segs, int* __restrict__ tape,
                int* __restrict__ steps) {
  extern __shared__ float4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  DenseScene sc = scene;
  sc.stage(base);
  const CameraRow cam = frt::load_camera(sc.tb.cam);
  frt::render_warp<kTape>(sc, cam, pp, ln,
                          base + DenseScene::smem_bytes(sc.tb.ns, sc.tb.nt),
                          rad, segs, tape, steps, nullptr);
}

// K2b.  At most 96 registers (92 used, no spills), five blocks an SM: at
// 2^17 rays 0.39-0.40 ms against 0.43-0.45 at eight blocks (64 registers,
// 86 bytes spilled) and 0.43 at six (probes/mega_grid.py, PERF.md).
__global__ void __launch_bounds__(kThreads, 5)
    record_kernel(const DenseScene scene, const PathParams pp,
                  const RecordLaunch ln, int* __restrict__ tape,
                  int* __restrict__ its, int* __restrict__ steps) {
  extern __shared__ float4 smem[];
  DenseScene sc = scene;
  sc.stage(reinterpret_cast<unsigned char*>(smem));
  const CameraRow cam = frt::load_camera(sc.tb.cam);
  frt::record_warp(sc, cam, pp, ln, tape, its, steps, nullptr);
}

}  // namespace

extern "C" {

// Launches K1 (tape == nullptr) or K2 on `stream` over `num_pixels` pixels
// starting at global pixel `pix0`; writes rad (num_pixels, 3) f32, segs
// (num_pixels,) i32, for K2 tape (max_depth + 1, num_pixels * spp) i32, and
// unless `steps` is null steps (num_pixels,) i32: each warp's segment steps
// at the first pixel of its first group, 0 elsewhere.  `work` is one int of
// device scratch, the launch's counter of groups handed out.
// `groups` is a host array: the 7 sphere group starts, then the 7 triangle
// ones.  Returns cudaGetLastError() after the launch (0 = launched).
int frt_mega_render(const float* cam, const float* sph, const float* mx,
                    const float* tri, int ns, int nt, int ns_pad, int nt_pad,
                    const int* groups, unsigned int k0, unsigned int k1,
                    int nx, int ny, int spp, int spp_total, int spp0,
                    int pix0, int num_pixels, int total_pixels,
                    int max_depth, float t_min, float* rad, int* segs,
                    int* tape, int* steps, int* work, void* stream) {
  const DenseScene scene{
      frt::make_tables(cam, sph, mx, tri, ns, nt, ns_pad, nt_pad, groups)};
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const RenderLaunch ln{spp,        spp_total,    spp0,          pix0,
                        num_pixels, total_pixels, chunk_of(spp), work};
  if (num_pixels > 0) {
    const int bytes = render_smem_bytes(ns, nt, ln.chunk);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = static_cast<int>(cudaMemsetAsync(work, 0, sizeof(int), st));
    if (err != 0) return err;
    if (tape != nullptr) {
      err = frt::allow_smem(mega_kernel<true>, bytes);
      if (err != 0) return err;
      const int blocks = frt::render_blocks(mega_kernel<true>, bytes,
                                            frt::pixel_groups(num_pixels));
      mega_kernel<true><<<blocks, kThreads, bytes, st>>>(scene, pp, ln, rad,
                                                         segs, tape, steps);
    } else {
      err = frt::allow_smem(mega_kernel<false>, bytes);
      if (err != 0) return err;
      const int blocks = frt::render_blocks(mega_kernel<false>, bytes,
                                            frt::pixel_groups(num_pixels));
      mega_kernel<false><<<blocks, kThreads, bytes, st>>>(
          scene, pp, ln, rad, segs, nullptr, steps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2b on `stream` over ray ids [ray0, ray0 + num_rays); writes tape
// (max_depth + 1, num_rays) i32, its (num_rays,) i32 and, unless `steps` is
// null, steps (num_rays,) i32: each warp's segment steps at the first ray of
// its first window, 0 elsewhere.  `work` is one int of device scratch, the
// launch's counter of windows handed out.  `groups` as for frt_mega_render.
// Returns cudaGetLastError() after the launch.
int frt_record_paths(const float* cam, const float* sph, const float* mx,
                     const float* tri, int ns, int nt, int ns_pad,
                     int nt_pad, const int* groups, unsigned int k0,
                     unsigned int k1, int nx, int ny, int spp_total,
                     int ray0, int num_rays, int max_depth, float t_min,
                     int* tape, int* its, int* steps, int* work,
                     void* stream) {
  const DenseScene scene{
      frt::make_tables(cam, sph, mx, tri, ns, nt, ns_pad, nt_pad, groups)};
  const PathParams pp{k0, k1, nx, ny, max_depth, t_min};
  const RecordLaunch ln{ray0, num_rays, spp_total, work};
  if (num_rays > 0) {
    const int bytes = DenseScene::smem_bytes(ns, nt);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int err = static_cast<int>(cudaMemsetAsync(work, 0, sizeof(int), st));
    if (err == 0) err = frt::allow_smem(record_kernel, bytes);
    if (err != 0) return err;
    const int windows =
        (num_rays + frt::kRecordWindow - 1) / frt::kRecordWindow;
    const int blocks = frt::render_blocks(record_kernel, bytes, windows);
    record_kernel<<<blocks, kThreads, bytes, st>>>(scene, pp, ln, tape, its,
                                                   steps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
