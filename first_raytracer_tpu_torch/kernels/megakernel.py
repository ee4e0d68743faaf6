"""Megakernel render: the whole forward path tracer as one kernel (K1), and
the same kernel recording the winner tape of the differentiable pass (K2).

Port of ``first_raytracer_tpu.kernels.megakernel``.  On a CUDA device
``render_pixels_mega`` launches the hand-written kernel in
``csrc/megakernel.cu``: persistent warps take groups of 32 pixels and
trace their samples to termination, a lane taking the next unstarted
sample whenever its path ends (in-kernel Threefry draws, thin-lens
camera, dense sphere and
triangle sweep over rows staged in shared memory with exact closest-hit
selection, lambertian / metal / dielectric scatter with the checker
texture, sky on a miss), and sums each pixel in sample order.  With
``emit_tape=True`` it launches the kernel's tape variant (K2), which also
writes each sample's winner tape.  On the CPU it runs
``render_pixels_mega_reference``, the same function in plain PyTorch.  A
tensor on any other device is refused; nothing falls back.

The host packs the scene once (``pack_scene_mega``, NumPy copied from the
JAX package): primitives sorted into six (material, texture) groups so the
winner's type follows from its index, and per-primitive material rows so
shading reads one payload row instead of chasing a material id.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..core import rng
from ..core import vecmath
from ..core.vecmath import divide

__all__ = ["MegaScenePack", "pack_scene_mega", "camera_table",
           "render_pixels_mega", "render_pixels_mega_reference",
           "render_image_mega", "render_image_mega_sharded",
           "load_mega_library"]

BIG = 1e30
_LANE = 128
# Sphere payload rows (16, Ns_pad): 0-2 center, 3 radius, 4 param
# (fuzz | ref_idx by group), 5-7 albedo, 8-10 albedo2, 11 tex_scale,
# 12 c0 = |C|^2 - r^2, 13 original scene index, 15 1/radius.
SPH_ROWS = 16
# Triangle payload rows (24, Nt_pad): 0-2 v0, 3-5 e1, 6-8 e2, 9-11 unit
# normal, 12 param, 13-15 albedo, 16-18 albedo2, 19 tex_scale, 20 original
# global id.
TRI_ROWS = 24
# The JAX kernel's packed selection caps a padded primitive type at 2^14;
# the port keeps the guard so both packages accept the same scenes.
MAX_PADDED_PRIMITIVES = 1 << 14
# The entry points that choose a kernel give the dense ones (K1, K2b) scenes
# of up to this many spheres and this many triangles, the JAX package's
# bound for its dense recorder, and larger scenes to the clustered ones (K3,
# K3t): ``make_fit_step_replay`` and ``cli render --mode mega``.
DENSE_MAX = 1024

KERNEL_SOURCE = "megakernel.cu"
# K3 and K3t (the clustered megakernel), K4 and K5 (the wavefront closest
# hits), K6 (the flat-BVH walk), K7 and K8 (the wavefront paths' Threefry
# draws and camera rays), K9 and K10 (the wavefront pass's shading and
# regeneration), K11 (the dense closest hit), K12 and K13 (the
# recorders' pass and regeneration), K14 and K15 (the tape replay's
# value and gradient) and K16 and K17 (the differentiable scan's row
# gathers and their sums) build into the same library.
CLUSTERED_SOURCE = "megakernel_clustered.cu"
INTERSECT_SOURCE = "intersect.cu"
BVH_SOURCE = "bvh_walk.cu"
RNG_RAYS_SOURCE = "rng_rays.cu"
# K9 and K10 (the wavefront pass's shading and regeneration), K12 and K13
# (the recorders' pass and the pool recorder's regeneration).
WAVEFRONT_PASS_SOURCE = "wavefront_pass.cu"
# K11 (the dense closest hit on the scene's own tensors).
DENSE_HIT_SOURCE = "dense_hit.cu"
# K14 and K15 (the tape replay's value and gradient).
REPLAY_SOURCE = "replay.cu"
# K16 and K17 (the differentiable scan's row gathers and their sums).
GATHER_ROWS_SOURCE = "gather_rows.cu"
REPLACES = "first_raytracer_tpu/kernels/megakernel.py:306"


def _round_up(x, m):
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MegaScenePack:
    """Host-packed scene for the megakernel, tensors on one device.

    ``sph_groups``/``tri_groups`` are the six cumulative group starts plus
    the total; groups are (lambertian, metal, dielectric) x (constant,
    checker).  ``sph_order``/``tri_order`` map a sorted index back to the
    scene's own index.
    """

    spheres: torch.Tensor  # (16, Ns_pad) f32
    sph_mx: torch.Tensor   # (Ns_pad, 8) f32: cx cy cz c0, cx cy cz r
    tris: torch.Tensor     # (24, Nt_pad) f32
    sphere_rows: int
    tri_rows: int
    sph_groups: tuple      # 7 ints
    tri_groups: tuple
    has_checker: bool
    sph_order: torch.Tensor  # (Ns,) i32
    tri_order: torch.Tensor  # (Nt,) i32

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    @property
    def sweep_columns(self) -> int:
        """Columns a dense sweep visits per ray: every primitive."""
        return self.sphere_rows + self.tri_rows

    def closest_hit(self, o, d, t_min):
        """Exact (min t, lowest sorted index) hit of rays ``o + t d``:
        ``(t, sphere winner, triangle winner, is_tri)``, t = BIG on a miss."""
        ns, nt = self.sphere_rows, self.tri_rows
        return _sweep(self.sph_mx[:ns] if ns else None,
                      self.tris[:, :nt] if nt else None, o, d, t_min)

    def winner_ids(self, w_s, w_t, is_tri):
        """Original scene ids of the winners (payload rows 13 and 20)."""
        return torch.where(is_tri, self.tris[20, w_t], self.spheres[13, w_s])

    def surface(self, p, w_s, w_t, is_tri):
        """The winners' surfaces at hit points ``p``: normal, material
        parameter, albedos, checker scale and (is_metal, is_diel,
        is_check), the types from the group ranges."""
        srow = self.spheres[:, w_s]  # (16, R) winner payload rows
        trow = self.tris[:, w_t]     # (24, R)
        types_t = _group_types(w_t, self.tri_groups)
        types_s = _group_types(w_s, self.sph_groups)
        return _merge_surface(srow, trow, p, is_tri, types_s, types_t)


def pack_scene_mega(scene, device=None) -> MegaScenePack:
    """Repack the SoA scene with per-primitive material rows (host, once).

    ``scene`` is a ``Scene`` (or its ``as_numpy()`` copy); the tables land
    on ``device``, by default the scene's.
    """
    if device is None:
        device = getattr(scene, "device", "cpu")
    s = scene.as_numpy() if hasattr(scene, "as_numpy") else scene
    ns, nt = s.sphere_center.shape[0], s.tri_v0.shape[0]
    ns_pad = max(_round_up(ns, _LANE), _LANE)
    nt_pad = max(_round_up(nt, _LANE), _LANE)
    mtype_all = np.asarray(s.mat_type, np.int64)
    textype_all = np.asarray(s.tex_type, np.int64)

    def group_order(mat_ids):
        """Stable sort into the 6 (mat, tex) groups; 7 cumulative starts."""
        m = np.asarray(mat_ids, np.int64)
        gkey = mtype_all[m] * 2 + (textype_all[m] == 1)
        order = np.argsort(gkey, kind="stable")
        counts = np.bincount(gkey, minlength=6)
        starts = np.concatenate([[0], np.cumsum(counts)])
        return order, tuple(int(x) for x in starts)

    def mat_rows(mat_ids):
        """param (fuzz|ref_idx by mat type), albedo, albedo2, tex_scale."""
        m = np.asarray(mat_ids)
        mt = mtype_all[m]
        param = np.where(
            mt == 1, np.asarray(s.fuzz, np.float32)[m],
            np.where(mt == 2, np.asarray(s.ref_idx, np.float32)[m],
                     np.float32(1.0)))
        return np.stack([
            param.astype(np.float32),
            *(np.asarray(s.albedo, np.float32)[m, k] for k in range(3)),
            *(np.asarray(s.albedo2, np.float32)[m, k] for k in range(3)),
            np.asarray(s.tex_scale, np.float32)[m],
        ])  # (8, N)

    has_checker = bool((textype_all == 1).any())

    sph_order_np = np.arange(ns, dtype=np.int32)
    tri_order_np = np.arange(nt, dtype=np.int32)
    sph = np.zeros((SPH_ROWS, ns_pad), np.float32)
    sph[0:3] = BIG  # sentinel: never-hit center, radius 0
    mx = np.zeros((ns_pad, 8), np.float32)
    mx[:, 0:3] = BIG
    mx[:, 7] = np.float32(np.nan)  # the sphere root's radius: a sure miss
    sph_groups = (0,) * 7
    if ns:
        order, sph_groups = group_order(s.sphere_mat)
        sph_order_np = np.asarray(order, np.int32)
        c = np.asarray(s.sphere_center, np.float32)[order]
        r = np.asarray(s.sphere_radius, np.float32)[order]
        sph[0:3, :ns] = c.T
        sph[3, :ns] = r
        sph[4:12, :ns] = mat_rows(np.asarray(s.sphere_mat)[order])
        sph[13, :ns] = np.asarray(order, np.float32)
        sph[15, :ns] = np.where(r != 0.0, 1.0 / np.where(r != 0, r, 1.0), 0.0)
        mx[:ns, 0:3] = c
        mx[:ns, 4:7] = c
        mx[:ns, 7] = r
        # |C|^2 - r^2 in f64: exact for the huge ground sphere, where f32
        # would cancel catastrophically.
        c64 = c.astype(np.float64)
        r64 = r.astype(np.float64)
        c0 = ((c64 * c64).sum(1) - r64 * r64).astype(np.float32)
        mx[:ns, 3] = c0
        sph[12, :ns] = c0
    # The JAX kernel's sentinel c0 = +inf.
    mx[ns:, 3] = np.float32(np.inf)
    sph[12, ns:] = np.float32(BIG)

    tri = np.zeros((TRI_ROWS, nt_pad), np.float32)
    tri_groups = (0,) * 7
    if nt:
        order, tri_groups = group_order(s.tri_mat)
        tri_order_np = np.asarray(order, np.int32)
        v0 = np.asarray(s.tri_v0, np.float32)[order]
        e1 = np.asarray(s.tri_v1, np.float32)[order] - v0
        e2 = np.asarray(s.tri_v2, np.float32)[order] - v0
        n = np.cross(e1, e2)
        nn = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(nn > 0, nn, 1.0)
        tri[0:3, :nt] = v0.T
        tri[3:6, :nt] = e1.T
        tri[6:9, :nt] = e2.T
        tri[9:12, :nt] = n.T
        tri[12:20, :nt] = mat_rows(np.asarray(s.tri_mat)[order])
        tri[20, :nt] = (ns + np.asarray(order)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return MegaScenePack(spheres=dev(sph), sph_mx=dev(mx), tris=dev(tri),
                         sphere_rows=ns, tri_rows=nt, sph_groups=sph_groups,
                         tri_groups=tri_groups, has_checker=has_checker,
                         sph_order=dev(sph_order_np),
                         tri_order=dev(tri_order_np))


def camera_table(camera) -> torch.Tensor:
    """(20,) f32 camera row: origin, lower_left, horizontal, vertical,
    lens u, lens v, lens radius, pad."""
    parts = [camera.origin, camera.lower_left, camera.horizontal,
             camera.vertical, camera.u, camera.v, camera.lens_radius]
    flat = [torch.as_tensor(p, dtype=torch.float32).reshape(-1)
            for p in parts]
    flat.append(torch.zeros(1, dtype=torch.float32, device=flat[0].device))
    return torch.cat(flat).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


# No contraction into fused multiply-adds: with it, the kernel and its
# plain version round differently often enough that paths diverge beyond
# the image bound at full size (PERF.md, Findings).
NVCC_EXTRA_FLAGS = ("--fmad=false",)


@functools.lru_cache(maxsize=None)
def load_mega_library():
    """Build (once per source and flags) and load the shared library of K1,
    K2, K2b, K3, K3t, K4, K5, K6, K7, K8, K9, K10, K11, K12, K13, K14 and
    K15: one nvcc a source, all at once.

    Returns ``(ctypes.CDLL, BuildInfo)``.
    """
    from .build import build_library

    lib, info = build_library(
        "frt_mega",
        [KERNEL_SOURCE, CLUSTERED_SOURCE, INTERSECT_SOURCE, BVH_SOURCE,
         RNG_RAYS_SOURCE, WAVEFRONT_PASS_SOURCE, DENSE_HIT_SOURCE,
         REPLAY_SOURCE, GATHER_ROWS_SOURCE],
        NVCC_EXTRA_FLAGS)
    return bind(lib), info


def bind(lib):
    """Declares the C entry points' argument and result types on ``lib``
    (the card's library, or the CPU tests' host build of the same
    sources)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    u32, f32 = ctypes.c_uint32, ctypes.c_float
    lib.frt_intersect_dense.argtypes = (
        [ptr] * 3 + [i32] * 2 + [ptr] + [i32] * 3 + [f32] + [ptr] * 3)
    lib.frt_intersect_dense.restype = i32
    lib.frt_intersect_clustered.argtypes = (
        [ptr] * 7 + [i32] + [ptr] * 5 + [i32] * 2 + [f32] + [ptr] * 4)
    lib.frt_intersect_clustered.restype = i32
    bind_bvh(lib)
    bind_rng_rays(lib)
    bind_wavefront_pass(lib)
    bind_dense_hit(lib)
    bind_replay(lib)
    bind_gather_rows(lib)
    # The clustered tables: 12 pointers, then ns, nt, the two supergroup
    # counts and the two column counts.
    tables = [ptr] * 12 + [i32] * 6
    lib.frt_mega_clustered_render.argtypes = (
        tables + [u32, u32] + [i32] * 6 + [f32] + [ptr] * 5)
    lib.frt_mega_clustered_render.restype = i32
    lib.frt_record_clustered.argtypes = (
        tables + [u32, u32] + [i32] * 6 + [f32] + [ptr] * 5)
    lib.frt_record_clustered.restype = i32
    lib.frt_mega_render.argtypes = (
        [ptr] * 4 + [i32] * 4
        + [ctypes.POINTER(i32), ctypes.c_uint32, ctypes.c_uint32]
        + [i32] * 9 + [ctypes.c_float] + [ptr] * 6)
    lib.frt_mega_render.restype = i32
    lib.frt_record_paths.argtypes = (
        [ptr] * 4 + [i32] * 4
        + [ctypes.POINTER(i32), ctypes.c_uint32, ctypes.c_uint32]
        + [i32] * 6 + [ctypes.c_float] + [ptr] * 5)
    lib.frt_record_paths.restype = i32
    lib.frt_error_string.argtypes = [i32]
    lib.frt_error_string.restype = ctypes.c_char_p
    return lib


def bind_bvh(lib):
    """Declares K6's C entry point's argument and result types on ``lib``
    (also a host build of ``bvh_walk.cu`` alone)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.frt_bvh_walk.argtypes = (
        [ptr] * 4 + [i32] * 2 + [ptr] * 2 + [i32] + [ptr] * 3 + [i32] * 3
        + [f32] + [i32] + [ptr] * 5)
    lib.frt_bvh_walk.restype = i32
    lib.frt_bvh_walk_shared_bytes.argtypes = [i32] * 3
    lib.frt_bvh_walk_shared_bytes.restype = i32
    return lib


def bind_rng_rays(lib):
    """Declares K7's and K8's C entry points' argument and result types on
    ``lib`` (also a host build of ``rng_rays.cu`` alone)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.frt_uniforms.argtypes = [ptr] * 3 + [i64] * 3 + [ptr] * 2
    lib.frt_uniforms.restype = i32
    for name in ("frt_camera_rays_f32", "frt_camera_rays_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 2 + [i64] * 4 + [ptr] * 10
        fn.restype = i32
    return lib


def bind_dense_hit(lib):
    """Declares K11's C entry point's argument and result types on ``lib``
    (also a host build of ``dense_hit.cu`` alone)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.frt_dense_hit.argtypes = (
        [ptr] * 5 + [i32] * 2 + [ptr] * 3 + [i64, ctypes.c_float]
        + [ptr] * 4)
    lib.frt_dense_hit.restype = i32
    return lib


def bind_replay(lib):
    """Declares K14's and K15's C entry points' argument and result types
    on ``lib`` (also a host build of ``replay.cu`` alone)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f64 = ctypes.c_double
    # The tables and their rows, then the ids, key and tape, its row
    # stride, rows, the depth cap, t_min and the rays.
    head = [ptr, i64, ptr, i64]
    tail = [ptr] * 3 + [i64, i32, i32, f64, i64]
    for t in ("f32", "f64"):
        fwd = getattr(lib, f"frt_replay_forward_{t}")
        fwd.argtypes = head + [ptr] * 2 + tail + [ptr] * 5
        fwd.restype = i32
        bwd = getattr(lib, f"frt_replay_backward_{t}")
        bwd.argtypes = head + tail + [ptr] * 9
        bwd.restype = i32
    lib.frt_replay_order.argtypes = [ptr] * 2 + [i32, i64] + [ptr] * 3
    lib.frt_replay_order.restype = i32
    lib.frt_replay_blocks.argtypes = [i32] * 2 + [ctypes.POINTER(i32)]
    lib.frt_replay_blocks.restype = i32
    return lib


def bind_gather_rows(lib):
    """Declares K16's and K17's C entry points' argument and result types
    on ``lib`` (also a host build of ``gather_rows.cu`` alone)."""
    desc, i32, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.c_int, \
        ctypes.c_int64
    ptr = ctypes.c_void_p
    for t in ("f32", "f64"):
        fwd = getattr(lib, f"frt_gather_rows_{t}")
        fwd.argtypes = [desc, i32, i64, ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"frt_row_sum_{t}")
        bwd.argtypes = [desc, i32, i64, ptr, ptr]
        bwd.restype = i32
    return lib


def bind_wavefront_pass(lib):
    """Declares K9's, K10's and K12's (K13 folded into its pool mode) C
    entry points' argument and result types on ``lib`` (also a host build of ``wavefront_pass.cu``
    alone)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f32 = ctypes.c_float
    # The key, the scene's seven primitive tensors and their two counts,
    # the material table's seven tensors and its rows.
    scene = [ptr] * 8 + [i32] * 2 + [ptr] * 7 + [i32]
    lib.frt_shade_pool.argtypes = (
        scene + [ptr] * 9 + [i64, i32, f32] + [ptr] * 5 + [i64, ptr])
    lib.frt_shade_pool.restype = i32
    lib.frt_shade_trip.argtypes = (
        scene + [ptr] * 10 + [i32, f32, i64, ptr])
    lib.frt_shade_trip.restype = i32
    lib.frt_regenerate.argtypes = (
        [ptr] * 8 + [i64] * 3 + [ptr] * 9 + [i64] * 2 + [ptr])
    lib.frt_regenerate.restype = i32
    lib.frt_record_step.argtypes = (
        scene + [ptr] * 10 + [i32, f32, i64, ptr])
    lib.frt_record_step.restype = i32
    lib.frt_record_pool.argtypes = (
        scene + [ptr] * 10 + [i64, i32, f32] + [ptr] * 10 + [i64] * 4
        + [ptr])
    lib.frt_record_pool.restype = i32
    return lib


def launch_entry(dev, name, *args):
    """Calls the library's C entry point ``name`` with ``args`` and the
    current stream of CUDA device ``dev``; raises if the launch failed."""
    lib, _ = load_mega_library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.frt_error_string(err).decode()} ({err})")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_pack(pack, cam):
    """The wrappers' checks of the camera row and the packed tables."""
    dev = pack.device
    f32 = torch.float32
    ns_pad, nt_pad = pack.spheres.shape[1], pack.tris.shape[1]
    _check("camera", cam, f32, (20,), dev)
    _check("spheres", pack.spheres, f32, (SPH_ROWS, ns_pad), dev)
    _check("sph_mx", pack.sph_mx, f32, (ns_pad, 8), dev)
    _check("tris", pack.tris, f32, (TRI_ROWS, nt_pad), dev)


def _launch_cuda(pack, cam, cfg, k0, k1, pix0, num_pixels, total_pixels,
                 spp0, spp_total, emit_tape, return_iters=False):
    """Launch K1 (or K2 with ``emit_tape``) on the current stream; returns
    (rad (P, 3), segs (P,)), then for K2 tape (D, P * spp), then with
    ``return_iters`` the warps' steps (P,)."""
    dev = pack.device
    check_pack(pack, cam)
    rad = torch.empty((num_pixels, 3), dtype=torch.float32, device=dev)
    segs = torch.empty((num_pixels,), dtype=torch.int32, device=dev)
    # K2 writes every entry of its tape: no fill needed.
    tape = (torch.empty((cfg.max_depth + 1, num_pixels * cfg.spp),
                        dtype=torch.int32, device=dev) if emit_tape else None)
    steps = (torch.empty((num_pixels,), dtype=torch.int32, device=dev)
             if return_iters else None)
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # its counter
    groups = (ctypes.c_int * 14)(*pack.sph_groups, *pack.tri_groups)
    launch_entry(
        dev, "frt_mega_render", cam.data_ptr(), pack.spheres.data_ptr(),
        pack.sph_mx.data_ptr(), pack.tris.data_ptr(), pack.sphere_rows,
        pack.tri_rows, pack.spheres.shape[1], pack.tris.shape[1], groups, k0,
        k1, cfg.nx, cfg.ny, cfg.spp, spp_total, spp0, pix0, num_pixels,
        total_pixels, cfg.max_depth, float(cfg.t_min), rad.data_ptr(),
        segs.data_ptr(), tape.data_ptr() if emit_tape else None,
        steps.data_ptr() if return_iters else None, work.data_ptr())
    if emit_tape:
        render_pixels_mega.tape_launches += 1
    else:
        render_pixels_mega.launches += 1
    return ((rad, segs) + ((tape,) if emit_tape else ())
            + ((steps,) if return_iters else ()))


def render_pixels_mega(pack: MegaScenePack, camera, cfg, key, spp0: int = 0,
                       spp_total: int = None, pix0: int = 0,
                       num_pixels: int = None, emit_tape: bool = False,
                       return_iters: bool = False):
    """Per-pixel radiance sums and segment counts for a render.

    Returns ``(radiance_sum (P, 3) f32, segments (P,) i32)`` for the
    ``P = num_pixels`` pixels starting at global pixel ``pix0`` (the whole
    image by default).  ``radiance_sum`` is the sum over the ``cfg.spp``
    samples ``spp0 .. spp0 + spp - 1`` of a ``spp_total``-sample render;
    divide by spp for the mean.  ``segments`` counts the traced ray
    segments of each pixel's paths.

    With ``emit_tape=True`` also returns the winner tape ``(D, P * spp)``
    i32, ``D = cfg.max_depth + 1``: column ``loc * spp + s`` is sample
    ``spp0 + s`` of local pixel ``loc``, and row ``d`` holds the original
    scene id (spheres, then triangles offset by Ns) of the primitive that
    path hit at bounce ``d``, or -1 on a miss or after the path ended: the
    contract of ``diff.replay.record_paths``.

    With ``return_iters=True`` also returns, last, the kernel's warps'
    segment steps ``(P,)`` i32, each warp's at the first pixel of the first
    group of 32 pixels it took (0 elsewhere): the warps' lanes take the
    next unstarted sample as their paths end, so segments / (32 x steps)
    is its lane efficiency.  The
    plain version gives the steps of a warp whose lanes each trace one
    pixel's samples in turn (its busiest pixel's segments), the schedule
    without regeneration.

    Runs K1 (K2 with ``emit_tape``) for CUDA tensors and the plain version
    for CPU tensors; the device is the pack's.  ``key`` is
    ``core.rng.base_key(seed)``.
    """
    num_pixels, total_pixels, spp_total = _extent(cfg, pix0, num_pixels,
                                                  spp_total)
    check_guards(pack, cfg)
    dev = pack.device
    if dev.type == "cpu":
        out = render_pixels_mega_reference(
            pack, camera, cfg, key, spp0=spp0, spp_total=spp_total,
            pix0=pix0, num_pixels=num_pixels, emit_tape=emit_tape)
        return out + (pixel_lane_steps(out[1]),) if return_iters else out
    if dev.type != "cuda":
        raise ValueError(f"no megakernel for device {dev}")
    k0, k1 = rng.key_words(key)
    return _launch_cuda(pack, camera_table(camera).to(dev), cfg, k0, k1,
                        pix0, num_pixels, total_pixels, spp0, spp_total,
                        emit_tape, return_iters)


render_pixels_mega.launches = 0  # K1 launches (CUDA path only)
render_pixels_mega.tape_launches = 0  # K2 launches (CUDA path only)


def pixel_lane_steps(segs):
    """(P,) i32: for each warp of 32 consecutive pixels, at its first
    pixel, the segments of its busiest pixel, the steps the warp takes
    when each lane traces one pixel's samples in turn; 0 elsewhere."""
    P = segs.shape[0]
    pad = torch.zeros((-P) % 32, dtype=segs.dtype, device=segs.device)
    most = torch.cat([segs, pad]).reshape(-1, 32).max(dim=1).values
    out = torch.zeros_like(segs)
    out[::32] = most
    return out


def _extent(cfg, pix0, num_pixels, spp_total):
    total_pixels = cfg.nx * cfg.ny
    if num_pixels is None:
        num_pixels = total_pixels - pix0
    if spp_total is None:
        spp_total = cfg.spp
    if num_pixels < 0 or pix0 < 0:
        raise ValueError(f"bad pixel range pix0={pix0} "
                         f"num_pixels={num_pixels}")
    if total_pixels * spp_total >= (1 << 32):
        raise ValueError("ray ids must fit in 32 bits")
    return num_pixels, total_pixels, spp_total


def check_guards(pack, cfg):
    """The JAX kernel's preconditions, kept so both accept the same input."""
    if not cfg.t_min > 0.0:
        raise ValueError(f"megakernel requires t_min > 0, got {cfg.t_min}")
    widest = max(pack.spheres.shape[1], pack.tris.shape[1])
    if widest > MAX_PADDED_PRIMITIVES:
        raise ValueError("megakernel supports at most 2^14 padded "
                         f"primitives per type, got {widest}")


# ---------------------------------------------------------------------------
# K1's plain version
# ---------------------------------------------------------------------------


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _normalize3(v, eps=0.0):
    n2 = _dot3(v, v)
    if eps:
        n2 = torch.clamp(n2, min=eps)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / vecmath.sqrt(torch.where(pos, n2, 1.0)),
                      0.0)
    return v * inv[:, None]


def _group_types(w, g):
    """(is_metal, is_diel, is_check) of sorted primitive indices ``w``."""
    metal = (w >= g[2]) & (w < g[4])
    diel = (w >= g[4]) & (w < g[6])
    check = (((w >= g[1]) & (w < g[2])) | ((w >= g[3]) & (w < g[4]))
             | ((w >= g[5]) & (w < g[6])))
    return metal, diel, check


def _sweep(mx, tri, o, d, t_min):
    """Dense sweep with exact (min t, lowest column) selection over sphere
    columns ``mx`` (N, 8) and triangle columns ``tri`` (24, M); either may
    be None for a scene without that type.

    Returns ``(t, sphere winner, triangle winner, is_tri)``; t = BIG on a
    miss, and a sphere wins a sphere/triangle tie.
    """
    R = o.shape[0]
    t_s = torch.full((R,), BIG, dtype=torch.float32, device=o.device)
    w_s = torch.zeros((R,), dtype=torch.int64, device=o.device)
    t_t, w_t = t_s, w_s
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    if mx is not None:
        # The kernels' sphere root (csrc/mega_common.cuh::sphere_group): b =
        # d.(o - C), c = |o - C|^2 - r^2, the discriminant and the roots in
        # float64 from the float32 (cx, cy, cz, r) row and ray, each root
        # rounded once to float32.  A NaN radius (padding) gives no root.
        cx, cy, cz, r = mx[:, 4:8].double().T
        o64, d64 = o.double(), d.double()
        px = o64[:, 0:1] - cx
        py = o64[:, 1:2] - cy
        pz = o64[:, 2:3] - cz
        bq = d64[:, 0:1] * px + d64[:, 1:2] * py + d64[:, 2:3] * pz
        cq = px * px + py * py + pz * pz - r * r
        del px, py, pz
        disc = bq * bq - cq
        sq = torch.sqrt(torch.where(disc >= 0, disc, -1.0))  # NaN: a miss
        tn = (-bq - sq).float()
        tf = (sq - bq).float()
        del bq, cq, disc, sq
        tall = torch.where(tn > t_min, tn,
                           torch.where(tf > t_min, tf, BIG))
        w_s = torch.argmin(tall, dim=1)  # first minimum on ties
        t_s = torch.gather(tall, 1, w_s[:, None])[:, 0]
    if tri is not None:
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[0:9]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) > 1e-9
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        uu = (tvx * px + tvy * py + tvz * pz) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv
        hit = (ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
               & (tt > t_min) & (tt < BIG))
        tall = torch.where(hit, tt, BIG)
        w_t = torch.argmin(tall, dim=1)
        t_t = torch.gather(tall, 1, w_t[:, None])[:, 0]
    is_tri = t_t < t_s
    return torch.where(is_tri, t_t, t_s), w_s, w_t, is_tri


def _merge_surface(srow, trow, p, is_tri, types_s, types_t):
    """Per-ray surface from the sphere and triangle winners' payload rows
    (16, R) and (24, R) and their (metal, diel, check) masks."""
    tri = is_tri[:, None]
    n = torch.where(tri, trow[9:12].T, (p - srow[0:3].T) * srow[15][:, None])
    param = torch.where(is_tri, trow[12], srow[4])
    alb = torch.where(tri, trow[13:16].T, srow[5:8].T)
    alb2 = torch.where(tri, trow[16:19].T, srow[8:11].T)
    tsc = torch.where(is_tri, trow[19], srow[11])
    types = tuple(torch.where(is_tri, a, b)
                  for a, b in zip(types_t, types_s))
    return n, param, alb, alb2, tsc, types


def _shade(pack, d, p, w_s, w_t, is_tri, u):
    """Scatter at the hit points: (new_dir, attenuation, scattered).  The
    winners' surfaces come from ``pack.surface``, so the dense and the
    clustered pack shade by the same code."""
    n, param, alb, alb2, tsc, (metal, diel, check) = pack.surface(
        p, w_s, w_t, is_tri)

    ball = rng.unit_ball_sample(u[:, 0], u[:, 1], u[:, 2])
    coin = u[:, 3]
    lam = _normalize3(n + ball, 1e-20)

    ddn = _dot3(d, n)
    refl = d - (2.0 * ddn)[:, None] * n
    mraw = refl + param[:, None] * ball
    metal_ok = _dot3(mraw, n) > 0.0
    met = _normalize3(mraw, 1e-20)

    # Dielectric: Snell with the TIR check; Schlick with the reference's
    # cosine = ref_idx * dot(d, N) when exiting.  The reflected or
    # refracted direction is normalized, as materials/scatter.py does (the
    # TPU kernel skips it): off a hit point a little inside or outside the
    # sphere the normal is short, and so would the direction be, which the
    # sphere root takes as a unit vector.
    outside = ddn > 0.0
    own = torch.where(outside[:, None], -n, n)
    ni = torch.where(outside, param, 1.0 / param)
    cosine = torch.where(outside, param * ddn, -ddn)
    uv = _normalize3(d)
    dt = _dot3(uv, own)
    disc2 = 1.0 - ni * ni * (1.0 - dt * dt)
    can = disc2 > 0
    sq2 = vecmath.sqrt(torch.where(can, disc2, 0.0))
    rf = torch.where(can[:, None], ni[:, None] * (uv - own * dt[:, None])
                     - own * sq2[:, None], 0.0)
    r0 = (1.0 - param) / (1.0 + param)
    r0 = r0 * r0
    om = 1.0 - cosine
    om2 = om * om
    schl = r0 + (1.0 - r0) * (om2 * om2 * om)
    use_refl = coin < torch.where(can, schl, 1.0)
    dielectric = _normalize3(torch.where(use_refl[:, None], refl, rf), 1e-20)

    sines = (vecmath.sin(tsc * p[:, 0]) * vecmath.sin(tsc * p[:, 1])
             * vecmath.sin(tsc * p[:, 2]))
    tex = torch.where((check & (sines < 0.0))[:, None], alb2, alb)

    new_dir = torch.where(diel[:, None], dielectric,
                          torch.where(metal[:, None], met, lam))
    att = torch.where(diel[:, None], 1.0, tex)
    return new_dir, att, metal_ok | ~metal


def _camera_rays(camera, cfg, pix, rid, key):
    """Thin-lens camera rays of pixels ``pix``, as the kernel computes them
    (``render.camera.generate_rays`` with the kernel's operation order).
    The draws are the plain ones, so that on the card this plain version
    launches no kernel."""
    u = rng.uniforms_plain(key, rid, rng.DOMAIN_CAMERA)
    i = (pix % cfg.nx).to(torch.float32)
    j = torch.div(pix, cfg.nx, rounding_mode="floor").to(torch.float32)
    s = divide(i + u[:, 0], cfg.nx)[:, None]
    t = divide(j + u[:, 1], cfg.ny)[:, None]
    rd = camera.lens_radius * rng.unit_disk_sample(u[:, 2], u[:, 3])
    offset = rd[:, 0:1] * camera.u + rd[:, 1:2] * camera.v
    origin = camera.origin + offset
    direction = (camera.lower_left + s * camera.horizontal
                 + t * camera.vertical - camera.origin - offset)
    return origin, _normalize3(direction)


def trace_reference(pack, camera, cfg, key, pix, rid):
    """Radiance (R, 3), segments (R,) and the winner tape (D, R) of the
    rays ``rid`` of pixels ``pix``: the path every kernel of the package
    traces, in plain PyTorch, on a dense or a clustered pack (its
    ``closest_hit``, ``winner_ids`` and ``surface``).

    Rays still alive are compacted each bounce, so the dense (R, Np)
    temporaries shrink as paths end.
    """
    dev = rid.device
    R = rid.shape[0]
    o, d = _camera_rays(camera, cfg, pix, rid, key)
    rad = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((R,), dtype=torch.int32, device=dev)
    tape = torch.full((cfg.max_depth + 1, R), -1, dtype=torch.int32,
                      device=dev)
    tp = torch.ones((R, 3), dtype=torch.float32, device=dev)
    idx = torch.arange(R, device=dev)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32, device=dev)
    for depth in range(cfg.max_depth + 1):
        if idx.numel() == 0:
            break
        segs[idx] += 1
        t, w_s, w_t, is_tri = pack.closest_hit(o, d, cfg.t_min)
        hit = t < BIG
        miss = ~hit
        skyt = 0.5 * (d[miss, 1] + 1.0)
        sky = (1.0 - skyt)[:, None] + skyt[:, None] * blue
        rad.index_add_(0, idx[miss], tp[miss] * sky)
        oid = pack.winner_ids(w_s, w_t, is_tri)
        tape[depth, idx[hit]] = oid[hit].to(torch.int32)
        idx, o, d, tp, t = idx[hit], o[hit], d[hit], tp[hit], t[hit]
        p = o + t[:, None] * d
        u = rng.uniforms_plain(key, rid[idx], depth + 1)
        new_dir, att, scattered = _shade(pack, d, p, w_s[hit], w_t[hit],
                                         is_tri[hit], u)
        cont = scattered & (depth < cfg.max_depth)
        idx, o, d, tp = idx[cont], p[cont], new_dir[cont], (tp * att)[cont]
    return rad, segs, tape


def default_rays_per_chunk(pack):
    """Rays per chunk of the plain versions: about 2^25 (ray, column)
    pairs, so the dense sweep's temporaries stay bounded."""
    prims = max(pack.sweep_columns, 1)
    return max(1 << 10, (1 << 25) // prims)


def render_pixels_mega_reference(pack: MegaScenePack, camera, cfg, key,
                                 spp0: int = 0, spp_total: int = None,
                                 pix0: int = 0, num_pixels: int = None,
                                 rays_per_chunk: int = None,
                                 emit_tape: bool = False):
    """K1's plain version (K2's with ``emit_tape``): ``render_pixels_mega``
    in plain PyTorch.

    Camera rays for every (pixel, sample), then the bounce loop of the
    kernel's shading math on the packed tables with exact closest-hit
    selection; the sum over samples gives the per-pixel result.  Runs on
    the pack's device, chunked over rays so the (rays, primitives)
    temporaries stay bounded.
    """
    check_guards(pack, cfg)
    return render_reference(pack, camera, cfg, key, spp0, spp_total, pix0,
                            num_pixels, rays_per_chunk, emit_tape)


def render_reference(pack, camera, cfg, key, spp0=0, spp_total=None,
                     pix0=0, num_pixels=None, rays_per_chunk=None,
                     emit_tape=False):
    """``render_pixels_mega_reference`` on a dense or a clustered pack,
    without the dense kernel's size guard: per-pixel radiance sums and
    segment counts (and the tape with ``emit_tape``) of
    ``trace_reference``'s paths."""
    num_pixels, total_pixels, spp_total = _extent(cfg, pix0, num_pixels,
                                                  spp_total)
    dev = pack.device
    camera = camera.to(dev)
    spp = cfg.spp
    rad = torch.zeros((num_pixels, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((num_pixels,), dtype=torch.int32, device=dev)
    tape = (torch.full((cfg.max_depth + 1, num_pixels * spp), -1,
                       dtype=torch.int32, device=dev) if emit_tape else None)
    live = max(0, min(num_pixels, total_pixels - pix0))
    if rays_per_chunk is None:
        rays_per_chunk = default_rays_per_chunk(pack)
    pix_chunk = max(1, rays_per_chunk // spp)
    samples = torch.arange(spp, dtype=torch.int64, device=dev)
    for lo in range(0, live, pix_chunk):
        hi = min(lo + pix_chunk, live)
        loc = torch.arange(lo, hi, device=dev)
        pix = pix0 + loc
        rid = (pix[:, None] * spp_total + spp0 + samples[None, :]).reshape(-1)
        r, sg, tp = trace_reference(pack, camera, cfg, key,
                                    pix.repeat_interleave(spp), rid)
        # The samples of a pixel added in order, as the kernels add them.
        r = r.reshape(-1, spp, 3)
        acc = r[:, 0]
        for k in range(1, spp):
            acc = acc + r[:, k]
        rad[loc] = acc
        segs[loc] = sg.reshape(-1, spp).sum(dim=1, dtype=torch.int32)
        if emit_tape:
            tape[:, lo * spp:hi * spp] = tp
    if emit_tape:
        return rad, segs, tape
    return rad, segs


def render_image_mega(scene, camera, cfg, seed: int = 0, device="cuda"):
    """Full-image render through the megakernel; (ny, nx, 3) linear, top
    row first.  The scene and camera are moved to ``device``: the CUDA
    kernel runs on ``"cuda"``, its plain version on ``"cpu"``."""
    device = torch.device(device)
    pack = pack_scene_mega(scene, device)
    rad, _ = render_pixels_mega(pack, camera.to(device), cfg,
                                rng.base_key(seed))
    img = (rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)
    return img.flip(0)


def render_image_mega_sharded(scene, camera, cfg, mesh, seed: int = 0,
                              device="cuda"):
    """Mesh-sharded megakernel render; (ny, nx, 3) on ``device``, top row
    first, the whole image on every rank.

    Data-parallel over the mesh's tile axis (``parallel/mesh.py``): each
    rank launches K1 over a contiguous range of ceil(P / tiles) pixels
    (the last range may run past the image; those pixels are not traced)
    with the globally keyed RNG, and the ranges are gathered.  K1 sums each
    pixel's samples in sample order whichever range holds it, so the image
    is bit-identical to ``render_image_mega``'s for any rank count.  Scene
    tables and camera are replicated (ranks of one tile index but another
    spp index render the same range); the only collective is the
    all-gather.  A pixel keeps its samples on one rank: spp sharding is
    the wavefront path's (``parallel/shard.py``).
    """
    from ..parallel.mesh import local_device

    device = local_device(device)
    return _sharded_image(render_pixels_mega,
                          pack_scene_mega(scene, device), camera.to(device),
                          cfg, mesh, seed)


def _sharded_image(render_pixels, pack, camera, cfg, mesh, seed: int):
    """The image of a megakernel's ``render_pixels`` (``render_pixels_mega``
    or ``render_pixels_mega_clustered``) on ``pack``, split over the mesh's
    tile axis: this rank renders a contiguous range of ceil(P / tiles)
    pixels (the last range may run past the image; those pixels are not
    traced), the ranges are all-gathered and divided by spp.  (ny, nx, 3),
    top row first, on every rank."""
    from ..parallel.mesh import TILE_AXIS

    total = cfg.num_pixels
    per = -(-total // mesh.tiles)
    rad, _ = render_pixels(pack, camera, cfg, rng.base_key(seed),
                           pix0=mesh.tile_index * per, num_pixels=per)
    rad = mesh.axis(TILE_AXIS).all_gather(rad)[:total]
    img = (rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)
    return img.flip(0)
