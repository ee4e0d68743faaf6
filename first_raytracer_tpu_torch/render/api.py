"""Top-level render API: a ray batch, or a whole image, through the
wavefront integrator.

Port of ``first_raytracer_tpu.render.api``.  The whole ``nx * ny * spp``
ray population is a flat id range.  ``mode="wavefront"`` processes it in
chunks, which bounds the dense sweep's (chunk, Np) temporaries;
``mode="regenerative"`` streams it through a compacted pool of ray slots
(``render/regenerative.py``).  Per-pixel averaging over spp and the
bottom-up -> top-down flip happen at the end.  The closest hit is
``intersect_fn`` on ``accel`` (``render/integrator.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import rng
from .camera import Camera, generate_rays
from .integrator import RenderConfig, trace_rays

__all__ = ["render_ray_batch", "render_rays", "render_image", "pixel_means",
           "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 15


def render_ray_batch(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                     accel=None, intersect_fn: Optional[Callable] = None,
                     return_stats: bool = False, **trace_kw):
    """Radiance for one batch of global ray ids; (R,) -> (R, 3) f32 (and
    the (R,) segment counts with ``return_stats``).  ``trace_kw`` goes to
    ``trace_rays`` (``resolve_fn``, ``sync_axis``)."""
    cam_u = rng.camera_uniforms(key, ray_ids)
    origin, direction = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp,
                                      ray_ids, cam_u)
    return trace_rays(scene, origin, direction, ray_ids, key, cfg,
                      accel=accel, intersect_fn=intersect_fn,
                      return_stats=return_stats, **trace_kw)


def render_rays(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                accel=None, intersect_fn: Optional[Callable] = None,
                chunk: Optional[int] = None, **trace_kw):
    """``render_ray_batch`` over ``ray_ids`` in chunks of ``chunk`` rays
    (``DEFAULT_CHUNK`` by default), each traced until its last path ends;
    (R, 3).  Each ray's radiance depends on its id alone, so the chunks do
    not change it.  ``trace_kw`` goes to ``trace_rays``."""
    chunk = min(max(ray_ids.shape[0], 1), chunk or DEFAULT_CHUNK)
    pieces = [render_ray_batch(scene, camera, cfg, key,
                               ray_ids[lo:lo + chunk], accel, intersect_fn,
                               **trace_kw)
              for lo in range(0, ray_ids.shape[0], chunk)]
    return torch.cat(pieces, dim=0)


def pixel_means(radiance, spp: int):
    """(N * spp, 3) per-ray radiance, pixel-major -> (N, 3) per-pixel
    means: each pixel's samples added in sample order, then divided by
    ``spp``, so that every caller (whole image or a block of pixels) rounds
    alike."""
    r = radiance.reshape(-1, spp, 3)
    acc = r[:, 0]
    for k in range(1, spp):
        acc = acc + r[:, k]
    return acc / spp


def render_image(scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 chunk: Optional[int] = None, mode: str = "wavefront",
                 pool_size: int = 1 << 16, device="cuda"):
    """Render the full image; (ny, nx, 3) linear radiance, row 0 = top.

    ``mode``: ``"wavefront"`` (chunks of ``chunk`` rays, each traced until
    its last path ends) or ``"regenerative"`` (a pool of ``pool_size``
    slots, clamped to the ray count as the JAX package clamps it, at least
    256).  The scene, camera and ``accel`` are moved to ``device``
    (``"cpu"`` to render on the host).
    """
    device = torch.device(device)
    scene, camera = scene.to(device), camera.to(device)
    if accel is not None:
        accel = accel.to(device)
    key = rng.base_key(seed)
    total = cfg.num_rays
    if mode == "regenerative":
        from .regenerative import render_rays_regenerative
        radiance = render_rays_regenerative(
            scene, camera, cfg, key, 0, total, accel, intersect_fn,
            pool_size=min(pool_size, max(total, 256)))
    elif mode == "wavefront":
        ids = torch.arange(total, dtype=torch.int64, device=device)
        radiance = render_rays(scene, camera, cfg, key, ids, accel,
                               intersect_fn, chunk)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    img = pixel_means(radiance, cfg.spp).reshape(cfg.ny, cfg.nx, 3)
    return img.flip(0)
