"""Thin-lens camera and primary-ray generation.

Port of ``first_raytracer_tpu.render.camera``.  Pixel convention:
``pixel = j * nx + i`` with ``j`` counted from the bottom row; image
writers flip.  Directions are unit length.

``camera_rays`` is what the wavefront paths call: the camera draw and
``generate_rays`` in one.  On a CUDA device it launches K8
(``kernels/csrc/rng_rays.cu``), one thread a ray, bit-equal to
``generate_rays`` on K7's draws as torch runs them there; on the CPU it
runs them (``generate_rays`` is K8's plain version).  A failed build or
launch raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..core.rng import (DOMAIN_CAMERA, device_key, uniforms_plain,
                        unit_disk_sample)
from ..core.vecmath import cross, divide, normalize

__all__ = ["Camera", "make_camera", "generate_rays", "camera_rays",
           "camera_rays_plain"]

REPLACES = "first_raytracer_tpu/render/camera.py:71"
_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
           "lens_radius")


@dataclass
class Camera:
    """Precomputed camera frame: f32 tensors on one device."""

    origin: torch.Tensor       # (3,)
    lower_left: torch.Tensor   # (3,)
    horizontal: torch.Tensor   # (3,)
    vertical: torch.Tensor     # (3,)
    u: torch.Tensor            # (3,) lens-plane basis
    v: torch.Tensor            # (3,)
    lens_radius: torch.Tensor  # ()

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)})


def make_camera(lookfrom, lookat, vup, vfov_deg, aspect, aperture=0.0,
                focus_dist=None, device="cpu") -> Camera:
    """Camera frame; ``focus_dist`` defaults to ``|lookfrom - lookat|``."""
    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lookfrom, lookat, vup = vec(lookfrom), vec(lookat), vec(vup)
    if focus_dist is None:
        focus_dist = float(torch.linalg.norm(lookfrom - lookat))
    theta = vfov_deg * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = aspect * half_height
    w = normalize(lookfrom - lookat)
    u = normalize(cross(vup, w))
    v = cross(w, u)
    lower_left = (lookfrom - half_width * focus_dist * u
                  - half_height * focus_dist * v - focus_dist * w)
    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=2.0 * half_width * focus_dist * u,
        vertical=2.0 * half_height * focus_dist * v,
        u=u,
        v=v,
        lens_radius=vec(aperture / 2.0),
    )


def generate_rays(camera: Camera, nx: int, ny: int, spp: int, ray_ids,
                  cam_uniforms):
    """Primary rays for a batch of global ray ids.

    Args:
      camera: Camera frame.
      nx, ny, spp: image config (ray id -> pixel, sample).
      ray_ids: (R,) integer ray ids (``pixel * spp + sample``).
      cam_uniforms: (R, 4) camera-domain uniforms (jitter u, v; lens u1, u2).

    Returns:
      (origin, direction): (R, 3) each, direction unit length.
    """
    pixel = torch.div(ray_ids, spp, rounding_mode="floor")
    i = (pixel % nx).to(torch.float32)
    j = torch.div(pixel, nx, rounding_mode="floor").to(torch.float32)
    s = divide(i + cam_uniforms[:, 0], nx)
    t = divide(j + cam_uniforms[:, 1], ny)
    # In the camera's dtype: torch would round a float64 camera's 0-d
    # radius down to the float32 samples', where JAX promotes.
    rd = camera.lens_radius * unit_disk_sample(
        cam_uniforms[:, 2], cam_uniforms[:, 3]).to(camera.lens_radius.dtype)
    offset = rd[:, 0:1] * camera.u + rd[:, 1:2] * camera.v
    origin = camera.origin + offset
    direction = (camera.lower_left + s[:, None] * camera.horizontal
                 + t[:, None] * camera.vertical - camera.origin - offset)
    return origin, normalize(direction)


def camera_rays_plain(camera: Camera, nx: int, ny: int, spp: int, key,
                      ray_ids):
    """K8's plain version: ``generate_rays`` on the plain camera draw
    (``core.rng.uniforms_plain``), torch ops on any device."""
    return generate_rays(camera, nx, ny, spp, ray_ids,
                         uniforms_plain(key, ray_ids, DOMAIN_CAMERA))


def _launch_cuda(camera, nx, ny, spp, key, ids):
    """K8 over the ids (a 1-D CUDA tensor): (origin, direction), (R, 3)
    each in the camera's dtype.  Makes no host read and allocates through
    torch, so a CUDA graph can capture it."""
    from ..kernels import megakernel

    dev = ids.device
    fields = [getattr(camera, f) for f in _FIELDS]
    dtype = camera.origin.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K8 takes a float32 or float64 camera, not "
                         f"{dtype}")
    for name, t in zip(_FIELDS, fields):
        shape = () if name == "lens_radius" else (3,)
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"camera.{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected {dtype} {shape} on {dev}")
        if t.requires_grad:
            raise ValueError(f"camera.{name} requires grad: K8 has no "
                             "gradient")
    if ids.dim() != 1:
        raise ValueError(f"ray ids must be 1-D, not {tuple(ids.shape)}")
    if min(nx, ny, spp) < 1:
        raise ValueError(f"bad image size {nx}x{ny}@{spp}")
    k = device_key(key, dev)
    ids = ids.to(torch.int64).contiguous()
    fields = [t.contiguous() for t in fields]
    R = ids.shape[0]
    origin = torch.empty((R, 3), dtype=dtype, device=dev)
    direction = torch.empty((R, 3), dtype=dtype, device=dev)
    name = ("frt_camera_rays_f32" if dtype == torch.float32
            else "frt_camera_rays_f64")
    megakernel.launch_entry(
        dev, name, k.data_ptr(), ids.data_ptr(), R, nx, ny, spp,
        *(t.data_ptr() for t in fields), origin.data_ptr(),
        direction.data_ptr())
    if R:
        camera_rays.launches += 1
    return origin, direction


def camera_rays(camera: Camera, nx: int, ny: int, spp: int, key, ray_ids):
    """Primary rays of global ray ids from their camera draws (RNG domain
    0): ``generate_rays(camera, nx, ny, spp, ray_ids, camera_uniforms(key,
    ray_ids))``.  Launches K8 for CUDA ids (a float32 or float64 camera on
    their device) and runs ``camera_rays_plain`` for CPU ids.  The camera
    gets no gradient."""
    ids = torch.as_tensor(ray_ids)
    if ids.device.type == "cpu":
        return camera_rays_plain(camera, nx, ny, spp, key, ids)
    if ids.device.type != "cuda":
        raise ValueError(f"no camera-ray kernel for device {ids.device}")
    return _launch_cuda(camera, int(nx), int(ny), int(spp), key, ids)


camera_rays.launches = 0  # K8 launches (CUDA path only)
