"""Top-level render API: chunked wavefront rendering to an image.

Port of ``first_raytracer_tpu.render.api`` (wavefront mode).  The whole
``nx * ny * spp`` ray population is a flat id range processed in chunks,
which bounds the dense sweep's (chunk, Np) temporaries; per-pixel averaging
over spp and the bottom-up -> top-down flip happen at the end.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from .camera import Camera, generate_rays
from .integrator import RenderConfig, trace_rays

__all__ = ["render_ray_batch", "render_image", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 15


def render_ray_batch(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                     return_stats: bool = False):
    """Radiance for one batch of global ray ids; (R,) -> (R, 3) f32."""
    cam_u = rng.camera_uniforms(key, ray_ids)
    origin, direction = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp,
                                      ray_ids, cam_u)
    return trace_rays(scene, origin, direction, ray_ids, key, cfg,
                      return_stats=return_stats)


def render_image(scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
                 chunk: Optional[int] = None, mode: str = "wavefront",
                 device="cuda"):
    """Render the full image; (ny, nx, 3) linear radiance, row 0 = top.

    The scene and camera are moved to ``device`` (``"cpu"`` to render on
    the host).  Only ``mode="wavefront"`` is ported; the regenerative pool
    integrator is not.
    """
    if mode != "wavefront":
        raise ValueError(f"unknown or unported mode {mode!r}")
    device = torch.device(device)
    scene, camera = scene.to(device), camera.to(device)
    key = rng.base_key(seed)
    total = cfg.num_rays
    chunk = min(total, chunk or DEFAULT_CHUNK)
    pieces = []
    for start in range(0, total, chunk):
        ids = torch.arange(start, min(start + chunk, total),
                           dtype=torch.int64, device=device)
        pieces.append(render_ray_batch(scene, camera, cfg, key, ids))
    radiance = torch.cat(pieces, dim=0)
    img = radiance.reshape(cfg.ny, cfg.nx, cfg.spp, 3).mean(dim=2)
    return img.flip(0)
