"""Thin-lens camera and primary-ray generation.

Port of ``first_raytracer_tpu.render.camera``.  Pixel convention:
``pixel = j * nx + i`` with ``j`` counted from the bottom row; image
writers flip.  Directions are unit length.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..core.rng import unit_disk_sample
from ..core.vecmath import cross, divide, normalize

__all__ = ["Camera", "make_camera", "generate_rays"]


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
