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
wavefront render to float rounding.

As in the JAX package, a pass (``pool_pass``) has fixed shapes and reads
nothing back to the host: the survivor count and the stream's cursor stay
on the device.  Past the closest hit a pass is ``render/wavefront_pass``'s
two seams.  On the CPU (``shade_plain``, ``regenerate_plain``) the
compaction and the regeneration are selects over every slot, and the sky
and segment counts go in by ``index_add_`` over all C slots (zero for the
others: adding 0.0 is exact, so the order of the adds cannot change a
bit).  On a CUDA device K9 shades every slot in one kernel, each live
slot adding to its own output row, and moves each survivor to its
compacted slot in place (a single-pass scan with decoupled look-back);
K10 makes camera rays for the tail only; bit-equal to those.  The host
reads "any slot alive" once per block of passes; on a CUDA device the
passes replay as a CUDA graph (``render/graphed.py``).  JAX compacts
with a scatter in which every dead lane collides at slot C - 1; the port
scatters the dead lanes after the survivors (a stable partition, a
permutation), which is deterministic on a GPU.  Slot C - 1 is a tail
slot whenever a lane died, so both give the same pool.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .camera import camera_rays
from .integrator import RenderConfig, closest_hit, default_intersect
from .wavefront_pass import pool_scratch, regenerate, shade

__all__ = ["pool_state", "pool_pass", "render_rays_regenerative"]


def _fresh_rays(camera, cfg, key, ids):
    """Camera rays for global ray ids (clamped into the image)."""
    ids = ids.clamp(0, cfg.num_rays - 1)
    return camera_rays(camera, cfg.nx, cfg.ny, cfg.spp, key, ids)


def pool_state(scene, camera, key, start_id, *, cfg, num_rays, pool_size,
               **_):
    """The pool's state before its first pass: slot s holds ray id
    ``start_id + s`` (alive while s < num_rays), the stream's ``cursor``
    (0-d int64), the (num_rays, 3) output, the (num_rays,) segment counts
    and the pass record and scan words of
    ``render.wavefront_pass.pool_scratch``.
    ``start_id`` is a 0-d int64 tensor on the scene's device."""
    C, dev, f32 = pool_size, scene.device, torch.float32
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    ids = start_id + slot
    o, d = _fresh_rays(camera, cfg, key, ids)
    n0 = min(C, num_rays)
    return dict(o=o, d=d, tp=torch.ones((C, 3), dtype=f32, device=dev),
                ids=ids, depth=torch.zeros((C,), dtype=torch.int64,
                                           device=dev),
                alive=slot < n0,
                cursor=torch.full((), n0, dtype=torch.int64, device=dev),
                out=torch.zeros((num_rays, 3), dtype=f32, device=dev),
                segments=torch.zeros((num_rays,), dtype=torch.int32,
                                     device=dev),
                **pool_scratch(C, dev))


@torch.no_grad()
def pool_pass(state, *, scene, camera, accel, key, start_id, cfg, num_rays,
              pool_size, intersect_fn, **_):
    """One pass of the pool, in place (the JAX package's loop body,
    ``regenerative.py:87-141``): no host read, every shape fixed.  Once
    every slot is dead and the stream is spent it changes nothing.  The
    closest hit, then ``render.wavefront_pass``'s two seams: ``shade`` (K9
    on a CUDA device) and ``regenerate`` (K10), their plain versions on the
    CPU."""
    prim, _, hit = closest_hit(intersect_fn, scene, accel, state["o"],
                               state["d"], cfg.t_min, state["alive"])
    shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
          start_id=start_id, num_rays=num_rays)
    regenerate(state, camera=camera, key=key, start_id=start_id, cfg=cfg,
               num_rays=num_rays, pool_size=pool_size)


@torch.no_grad()
def render_rays_regenerative(scene, camera, cfg: RenderConfig, key,
                             start_id: int, num_rays: int, accel=None,
                             intersect_fn: Optional[Callable] = None,
                             pool_size: int = 1 << 16,
                             return_stats: bool = False,
                             graphed: Optional[bool] = None):
    """Trace rays [start_id, start_id + num_rays) through a pool of
    ``pool_size`` slots; returns their (num_rays, 3) radiance on the
    scene's device, and with ``return_stats=True`` also their (num_rays,)
    int32 segment counts, as ``trace_rays`` counts them (a pass adds one
    to each slot that is alive).

    ``pool_state`` and ``pool_pass`` run in blocks of
    ``render.graphed.PASSES_PER_READ`` passes, one read of "any slot
    alive" per block; on a CUDA device as CUDA graphs
    (``render.graphed.LOOPS``, ``start_id`` as data) unless
    ``graphed=False`` (``render.graphed.graphed_route``)."""
    from .graphed import run_loop
    static = dict(cfg=cfg, num_rays=num_rays, pool_size=pool_size,
                  intersect_fn=intersect_fn or default_intersect)
    inputs = dict(scene=scene, camera=camera, accel=accel, key=key,
                  start_id=torch.full((), int(start_id), dtype=torch.int64,
                                      device=scene.device))
    state = run_loop(pool_state, pool_pass, static, inputs, scene.device,
                     ("out", "segments"), graphed)
    return (state["out"], state["segments"]) if return_stats \
        else state["out"]
