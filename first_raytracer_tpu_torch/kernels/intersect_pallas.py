"""Dense closest hit of a ray batch (K4): the wavefront integrator's
intersector for small scenes.

Port of ``first_raytracer_tpu.kernels.intersect_pallas``.  For every ray,
the nearest hit past ``t_min`` among every sphere (the oc-form quadratic of
``geometry/sphere.py``) and every triangle (Möller–Trumbore): the lowest
sphere index wins a tie, triangles are numbered from Ns and win only at a
strictly smaller t, and a miss gives t = 1e30 and prim 0.  On a CUDA device
``intersect_pallas`` launches the hand-written kernel in
``csrc/intersect.cu``, which stages the planes through shared memory in
tiles rewritten as (cx, cy, cz, r*r) and (v0, v1 - v0, v2 - v0) rows and
tests each staged primitive against several rays a thread; on the CPU it
runs ``intersect_pallas_reference``, the same function in plain PyTorch,
with the kernel's operation order.  A tensor on any other device is refused;
nothing falls back.

``pack_scene_pallas`` is the JAX package's host NumPy, copied, so the
tables are equal to JAX's array for array (padded with never-hit columns).
The kernel reads only the true columns.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..geometry.sphere import BIG

__all__ = ["PallasScenePack", "pack_scene_pallas", "intersect_pallas",
           "intersect_pallas_reference"]

REPLACES = "first_raytracer_tpu/kernels/intersect_pallas.py:93"
_LANE = 128
# (ray, column) pairs per chunk of the plain versions: their dense
# temporaries stay at a few hundred MB.
PLAIN_PAIRS = 1 << 25


def _round_up(x, m):
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PallasScenePack:
    """Scene SoA repacked plane-major, tensors on one device."""

    spheres: torch.Tensor  # (8, Ns_pad) f32: cx cy cz r pad pad pad pad
    tris: torch.Tensor     # (16, Nt_pad) f32: v0 v1 v2 coords (9 rows) + pad
    sphere_rows: int       # true Ns (<= Ns_pad)
    tri_rows: int          # true Nt

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def to(self, device) -> "PallasScenePack":
        return dataclasses.replace(self, spheres=self.spheres.to(device),
                                   tris=self.tris.to(device))


def pack_scene_pallas(scene) -> PallasScenePack:
    """Host-side repack (once per scene); the tables land on the scene's
    device."""
    s = scene.as_numpy()
    ns = s.sphere_center.shape[0]
    nt = s.tri_v0.shape[0]
    ns_pad = max(_round_up(ns, _LANE), _LANE)
    nt_pad = max(_round_up(nt, _LANE), _LANE)
    sph = np.full((8, ns_pad), 1e30, np.float32)
    sph[3:] = 0.0
    if ns:
        c = np.asarray(s.sphere_center, np.float32)
        sph[0, :ns] = c[:, 0]
        sph[1, :ns] = c[:, 1]
        sph[2, :ns] = c[:, 2]
        sph[3, :ns] = np.asarray(s.sphere_radius, np.float32)
    tri = np.zeros((16, nt_pad), np.float32)
    if nt:
        for row, (arr, k) in enumerate(
                (np.asarray(getattr(s, f"tri_v{i}"), np.float32), j)
                for i in range(3) for j in range(3)):
            tri[row, :nt] = arr[:, k]
    return PallasScenePack(spheres=torch.from_numpy(sph).to(scene.device),
                           tris=torch.from_numpy(tri).to(scene.device),
                           sphere_rows=ns, tri_rows=nt)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def check_rays(origin, direction, dev):
    """The rays as the kernels take them: (R, 3) f32, contiguous, on the
    pack's device."""
    for name, x in (("origin", origin), ("direction", direction)):
        if x.device != dev:
            raise ValueError(f"{name} is on device {x.device}, expected "
                             f"{dev}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             "expected (R, 3)")
    if origin.shape != direction.shape:
        raise ValueError("origin and direction differ in shape")
    return (origin.to(torch.float32).contiguous(),
            direction.to(torch.float32).contiguous())


def _launch_cuda(pack, o, d, t_min):
    from . import megakernel
    from .megakernel import _check

    dev = pack.device
    _check("spheres", pack.spheres, torch.float32,
           (8, pack.spheres.shape[1]), dev)
    _check("tris", pack.tris, torch.float32, (16, pack.tris.shape[1]), dev)
    for name, x in (("spheres", pack.spheres), ("tris", pack.tris)):
        # The kernel copies whole 16-byte runs of each plane into its tiles.
        if x.data_ptr() % 16 or x.shape[1] % 4:
            raise ValueError(f"{name} is not in 16-byte aligned planes")
    R = o.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    megakernel.launch_entry(
        dev, "frt_intersect_dense", o.data_ptr(), d.data_ptr(),
        pack.spheres.data_ptr(), pack.sphere_rows, pack.spheres.shape[1],
        pack.tris.data_ptr(), pack.tri_rows, pack.tris.shape[1], R,
        ctypes.c_float(t_min), t.data_ptr(), prim.data_ptr())
    if R:
        intersect_pallas.launches += 1
    return prim, t


def intersect_pallas(scene, accel, origin, direction, t_min):
    """Closest hit of rays ``origin + t direction`` (R, 3) against the
    packed scene ``accel`` (a ``PallasScenePack``): ``(prim, t, hit)``, the
    contract of ``render.integrator.intersect_brute``.

    Launches K4 for CUDA tensors and runs the plain version for CPU
    tensors; the device is the pack's.  ``scene`` is not read (the
    integrator's intersector signature).
    """
    dev = accel.device
    o, d = check_rays(origin, direction, dev)
    if dev.type == "cpu":
        return intersect_pallas_reference(scene, accel, o, d, t_min)
    if dev.type != "cuda":
        raise ValueError(f"no dense intersect kernel for device {dev}")
    prim, t = _launch_cuda(accel, o, d, float(t_min))
    return prim, t, t < BIG


intersect_pallas.launches = 0  # K4 launches (CUDA path only)


def sphere_oc_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r, t_min):
    """(R, N) oc-form hit distances (BIG = miss) of rays given as (R, 1)
    components against spheres given as (N,) rows, component by component
    in the kernel's operation order."""
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    has_root = disc > 0
    # The square root in float64, rounded once to float32: correctly
    # rounded, as the kernel's sqrtf is.  torch's vectorised float32 sqrt on
    # the CPU is not (it is an ulp off on about 0.7% of inputs).
    sq = torch.sqrt(torch.where(has_root, disc, 0.0).double()).float()
    t_near = -b - sq
    t_far = -b + sq
    near_ok = has_root & (t_near > t_min) & (t_near < BIG)
    far_ok = has_root & (t_far > t_min) & (t_far < BIG)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, BIG))


def triangle_mt_t(ox, oy, oz, dx, dy, dz, v, t_min):
    """(R, N) Möller–Trumbore hit distances (BIG = miss) against triangles
    given as nine (N,) vertex rows ``v`` (v0, v1, v2), in the kernel's
    operation order."""
    e1x, e1y, e1z = v[3] - v[0], v[4] - v[1], v[5] - v[2]
    e2x, e2y, e2z = v[6] - v[0], v[7] - v[1], v[8] - v[2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-9
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx = ox - v[0]
    ty = oy - v[1]
    tz = oz - v[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (tt > t_min)
           & (tt < BIG))
    return torch.where(hit, tt, BIG)


def ray_chunks(o, d, columns):
    """Slices of the ray batch, each (R_chunk, 1) components, so that the
    plain versions' (rays, columns) temporaries stay bounded."""
    step = max(1, PLAIN_PAIRS // max(columns, 1))
    for lo in range(0, o.shape[0], step):
        oc, dc = o[lo:lo + step], d[lo:lo + step]
        yield lo, [oc[:, k:k + 1] for k in range(3)] + [
            dc[:, k:k + 1] for k in range(3)]


def _first_min(t_all):
    """Row minima of (R, N) ``t_all`` and their first column."""
    col = torch.argmin(t_all, dim=1)  # the first minimum on ties
    return torch.gather(t_all, 1, col[:, None])[:, 0], col


def intersect_pallas_reference(scene, accel, origin, direction, t_min):
    """K4's plain version: ``intersect_pallas`` in plain PyTorch on the
    pack's true columns, on the rays' device."""
    pack = accel
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    R = o.shape[0]
    ns, nt = pack.sphere_rows, pack.tri_rows
    t = torch.full((R,), BIG, dtype=torch.float32, device=o.device)
    prim = torch.zeros((R,), dtype=torch.int64, device=o.device)
    sph = pack.spheres[:4, :ns]
    tri = pack.tris[:9, :nt]
    for lo, ray in ray_chunks(o, d, ns + nt):
        hi = lo + ray[0].shape[0]
        t_best = torch.full((hi - lo,), BIG, dtype=torch.float32,
                            device=o.device)
        p_best = torch.zeros((hi - lo,), dtype=torch.int64, device=o.device)
        if ns:
            t_best, p_best = _first_min(sphere_oc_t(*ray, *sph, t_min))
        if nt:
            t_tri, p_tri = _first_min(triangle_mt_t(*ray, tri, t_min))
            better = t_tri < t_best
            t_best = torch.where(better, t_tri, t_best)
            p_best = torch.where(better, p_tri + ns, p_best)
        t[lo:hi] = t_best
        prim[lo:hi] = p_best
    return prim.to(torch.int32), t, t < BIG
