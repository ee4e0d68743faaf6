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
from .camera import Camera, camera_rays
from .integrator import (RenderConfig, default_intersect, forward_trips,
                         trace_rays, trace_state)

__all__ = ["batch_state", "render_ray_batch", "render_rays", "render_image",
           "pixel_means", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 15


def batch_state(scene, camera, key, ray_ids, *, cfg, **_):
    """``trace_state`` of the camera rays of ``ray_ids``: the init body of
    the chunked batch's loop."""
    origin, direction = camera_rays(camera, cfg.nx, cfg.ny, cfg.spp, key,
                                    ray_ids)
    return trace_state(origin, direction, ray_ids)


def render_ray_batch(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                     accel=None, intersect_fn: Optional[Callable] = None,
                     return_stats: bool = False,
                     graphed: Optional[bool] = None, **trace_kw):
    """Radiance for one batch of global ray ids; (R,) -> (R, 3) f32 (and
    the (R,) segment counts with ``return_stats``).  ``trace_kw`` goes to
    ``trace_rays`` (``resolve_fn``, ``sync_axis``), which then traces the
    camera rays eagerly; without it the camera rays and the trips are one
    loop (``batch_state``, ``trip``), on a CUDA device replayed as CUDA
    graphs unless ``graphed=False`` (``render.graphed.graphed_route``)."""
    if intersect_fn is None:
        intersect_fn = default_intersect
    if trace_kw or cfg.differentiable:
        origin, direction = camera_rays(camera, cfg.nx, cfg.ny, cfg.spp,
                                        key, ray_ids)
        return trace_rays(scene, origin, direction, ray_ids, key, cfg,
                          accel=accel, intersect_fn=intersect_fn,
                          return_stats=return_stats, **trace_kw)
    out = forward_trips(batch_state, dict(scene=scene, camera=camera,
                                          accel=accel, key=key,
                                          ray_ids=ray_ids),
                        cfg, intersect_fn, graphed)
    return out if return_stats else out[0]


def render_rays(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                accel=None, intersect_fn: Optional[Callable] = None,
                chunk: Optional[int] = None, **trace_kw):
    """``render_ray_batch`` over ``ray_ids`` in chunks of ``chunk`` rays
    (``DEFAULT_CHUNK`` by default), each traced until its last path ends;
    (R, 3).  The last chunk is padded to the chunk's shape with the last
    id, as the JAX package pads it, and the padding sliced off, so that a
    frame has one shape of batch.  Each ray's radiance depends on its id
    alone, so neither the chunks nor the padding change it.  ``trace_kw``
    goes to ``render_ray_batch``."""
    R = ray_ids.shape[0]
    chunk = min(max(R, 1), chunk or DEFAULT_CHUNK)
    pieces = []
    for lo in range(0, R, chunk):
        ids = ray_ids[lo:lo + chunk]
        if ids.shape[0] < chunk:
            ids = torch.cat([ids, ids[-1:].expand(chunk - ids.shape[0])])
        pieces.append(render_ray_batch(scene, camera, cfg, key, ids, accel,
                                       intersect_fn, **trace_kw))
    return torch.cat(pieces, dim=0)[:R]


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
                 pool_size: int = 1 << 16, device="cuda",
                 graphed: Optional[bool] = None):
    """Render the full image; (ny, nx, 3) linear radiance, row 0 = top.

    ``mode``: ``"wavefront"`` (chunks of ``chunk`` rays, each traced until
    its last path ends) or ``"regenerative"`` (a pool of ``pool_size``
    slots, clamped to the ray count as the JAX package clamps it, at least
    256).  The scene, camera and ``accel`` are moved to ``device``
    (``"cpu"`` to render on the host).  On a CUDA device both modes replay
    CUDA graphs of their loops unless ``graphed=False``
    (``render.graphed.graphed_route``: a Python ``intersect_fn`` must say
    which).
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
            pool_size=min(pool_size, max(total, 256)), graphed=graphed)
    elif mode == "wavefront":
        ids = torch.arange(total, dtype=torch.int64, device=device)
        radiance = render_rays(scene, camera, cfg, key, ids, accel,
                               intersect_fn, chunk, graphed=graphed)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    img = pixel_means(radiance, cfg.spp).reshape(cfg.ny, cfg.nx, 3)
    return img.flip(0)
