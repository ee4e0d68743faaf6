"""Regenerative wavefront integrator: stream compaction and path
regeneration.

Port of ``first_raytracer_tpu.render.regenerative``.  A fixed pool of ray
slots is kept near full by

1. tracing one bounce of every pooled ray,
2. adding the sky radiance of the rays that miss into the per-ray output
   (a ray misses at most once and ends there, so each output row receives
   one sum, as in the plain integrator),
3. compacting the survivors to the front of the pool, in order, and
4. refilling the freed tail with fresh camera rays from the id stream.

The per-ray math is ``trace_rays``'s (the counter RNG keys each draw by ray
id and depth, which travel with the ray), so the result equals the
wavefront render to float rounding.  The loop runs on the host: each pass
reads the survivor count back from the device.

The JAX package compacts with a scatter in which every dead lane collides
at slot C - 1; the port compacts with a boolean mask (``x[cont]``), a
stable partition with no colliding writes, which is deterministic on a GPU.
Slot C - 1 is a tail slot whenever a lane died, so both give the same pool.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import rng
from ..materials.scatter import scatter
from .camera import generate_rays
from .integrator import (BIG, RenderConfig, default_intersect, recompute_hit,
                         sky_color)

__all__ = ["render_rays_regenerative"]


@torch.no_grad()
def render_rays_regenerative(scene, camera, cfg: RenderConfig, key,
                             start_id: int, num_rays: int, accel=None,
                             intersect_fn: Optional[Callable] = None,
                             pool_size: int = 1 << 16):
    """Trace rays [start_id, start_id + num_rays) through a pool of
    ``pool_size`` slots; returns their (num_rays, 3) radiance on the
    scene's device."""
    if intersect_fn is None:
        intersect_fn = default_intersect
    C = pool_size
    dev = scene.device
    f32 = torch.float32
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)

    def fresh_rays(ids):
        """Camera rays for global ray ids (clamped into the image)."""
        ids = ids.clamp(0, cfg.num_rays - 1)
        return generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ids,
                             rng.camera_uniforms(key, ids))

    out = torch.zeros((num_rays, 3), dtype=f32, device=dev)
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    ids = start_id + slot
    o, d = fresh_rays(ids)
    tp = torch.ones((C, 3), dtype=f32, device=dev)
    depth = torch.zeros((C,), dtype=torch.int64, device=dev)
    cursor = min(C, num_rays)
    alive = slot < cursor
    while bool(alive.any()):
        prim, _, hit = intersect_fn(scene, accel, o, d, cfg.t_min)
        t, p, n, mat = recompute_hit(scene, o, d, prim, cfg.t_min)
        hit = hit & (t < BIG)
        p = torch.where(hit[:, None], p, 0.0)
        n = torch.where(hit[:, None], n, up)

        new_dir, attenuation, ok = scatter(
            scene, mat, d, p, n, rng.bounce_uniforms(key, ids, depth))
        cont = alive & hit & ok & (depth < cfg.max_depth)

        # Rays that miss add the sky and end; the others end in black.
        miss = alive & ~hit
        out.index_add_(0, (ids[miss] - start_id).clamp(0, num_rays - 1),
                       tp[miss] * sky_color(d[miss]))

        # Compaction: the survivors, in order, to the front of the pool.
        n_alive = int(cont.sum())
        o, d = p[cont], new_dir[cont]
        tp = (tp * attenuation)[cont]
        ids, depth = ids[cont], depth[cont] + 1

        # Regeneration: the tail from the primary stream.
        fresh_idx = cursor + torch.arange(C - n_alive, dtype=torch.int64,
                                          device=dev)
        fresh_ids = start_id + fresh_idx.clamp(0, num_rays - 1)
        fo, fd = fresh_rays(fresh_ids)
        o, d = torch.cat([o, fo]), torch.cat([d, fd])
        tp = torch.cat([tp, torch.ones((C - n_alive, 3), dtype=f32,
                                       device=dev)])
        ids = torch.cat([ids, fresh_ids])
        depth = torch.cat([depth, torch.zeros_like(fresh_idx)])
        alive = torch.cat([torch.ones((n_alive,), dtype=torch.bool,
                                      device=dev), fresh_idx < num_rays])
        cursor += min(C - n_alive, max(num_rays - cursor, 0))
    return out
