"""Wavefront path-tracing integrator (forward).

Port of ``first_raytracer_tpu.render.integrator``.  The reference's
recursive ``color(ray, world, depth)`` becomes at most ``max_depth + 1``
breadth-wise passes over the whole ray population with ``alive`` masks; a
carried ``throughput`` replaces the recursion's product.  A ray that misses
adds ``throughput * sky`` and dies; a metal-absorbed ray, or one still
alive at the depth cap, adds black.  ``t_min = 1e-3`` is the reference's
shadow-acne bound.

Closest hit is pluggable: ``intersect_fn(scene, accel, origin, direction,
t_min) -> (prim, t, hit)``, by default ``default_intersect``, which takes
the dense all-pairs sweep (``intersect_brute``) without an accel and
dispatches on the accel's type otherwise: K4 (``kernels/intersect_pallas``),
K5 (``kernels/intersect_clustered``) or the flat-BVH walk
(``accel/traverse``).  The hit record is then recomputed from the winning
primitive (``recompute_hit``), which is the authority on whether it really
hits, so gradients flow through the hit equation whatever found the
primitive.  This is the port's CPU-runnable yardstick for the megakernel
(``kernels/megakernel.py``).  The ring-sharded scene's ``resolve_fn`` and
``sync_axis`` hooks are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core import rng
from ..core.vecmath import point_at
from ..geometry.sphere import (BIG, sphere_hit_all, sphere_hit_one,
                               sphere_normal)
from ..geometry.triangle import (triangle_hit_all, triangle_hit_one,
                                 triangle_normal)
from ..materials.scatter import scatter

__all__ = ["RenderConfig", "default_intersect", "intersect_brute",
           "recompute_hit", "sky_color", "trace_rays"]


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings."""

    nx: int = 200
    ny: int = 100
    spp: int = 100
    max_depth: int = 50
    t_min: float = 1e-3
    # Differentiable path: a fixed max_depth + 1 trips, no early exit (the
    # JAX package's reverse-mode scan); forward path: stop once all rays
    # are dead.
    differentiable: bool = False

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    @property
    def num_rays(self) -> int:
        return self.num_pixels * self.spp


_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction):
    """Miss shader: vertical white -> blue lerp; (R, 3)."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = torch.tensor(_WHITE, dtype=torch.float32, device=direction.device)
    blue = torch.tensor(_BLUE, dtype=torch.float32, device=direction.device)
    return (1.0 - t)[:, None] * white + t[:, None] * blue


@torch.no_grad()
def default_intersect(scene, accel, origin, direction, t_min):
    """Closest hit by the accel's type: the dense sweep (None), K5
    (``ClusteredScenePack``), K4 (``PallasScenePack``) or the flat-BVH walk
    (``FlatBVH``).  Runs without autograd: it only finds the primitive."""
    if accel is None:
        return intersect_brute(scene, origin, direction, t_min)
    from ..kernels.intersect_clustered import (ClusteredScenePack,
                                               intersect_clustered)
    if isinstance(accel, ClusteredScenePack):
        return intersect_clustered(scene, accel, origin, direction, t_min)
    from ..kernels.intersect_pallas import PallasScenePack, intersect_pallas
    if isinstance(accel, PallasScenePack):
        return intersect_pallas(scene, accel, origin, direction, t_min)
    from ..accel.traverse import intersect_bvh
    return intersect_bvh(scene, accel, origin, direction, t_min)


def intersect_brute(scene, origin, direction, t_min):
    """Dense closest hit over every (ray, primitive) pair.

    Returns ``(prim_id, t, hit)``; the lowest global id wins a tie.
    """
    parts = []
    if scene.num_spheres:
        parts.append(sphere_hit_all(origin, direction, scene.sphere_center,
                                    scene.sphere_radius, t_min, BIG))
    if scene.num_triangles:
        parts.append(triangle_hit_all(origin, direction, scene.tri_v0,
                                      scene.tri_v1, scene.tri_v2, t_min, BIG))
    t_all = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    prim = torch.argmin(t_all, dim=1)  # first minimum on ties
    t = torch.gather(t_all, 1, prim[:, None])[:, 0]
    return prim.to(torch.int32), t, t < BIG


def recompute_hit(scene, origin, direction, prim, t_min):
    """Hit record ``(t, p, n, mat_id)`` re-solved from the primitive id."""
    ns, nt = scene.num_spheres, scene.num_triangles
    prim = prim.long()
    if nt == 0:
        si = torch.clamp(prim, 0, ns - 1)
        c = scene.sphere_center[si]
        r = scene.sphere_radius[si]
        t = sphere_hit_one(origin, direction, c, r, t_min, BIG)
        p, n = sphere_normal(origin, direction, t, c, r)
        return t, p, n, scene.sphere_mat[si]
    if ns == 0:
        ti = torch.clamp(prim, 0, nt - 1)
        v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
        t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
        p = point_at(origin, direction, t)
        return t, p, triangle_normal(v0, v1, v2), scene.tri_mat[ti]

    is_sph = prim < ns
    si = torch.clamp(prim, 0, ns - 1)
    ti = torch.clamp(prim - ns, 0, nt - 1)
    c = scene.sphere_center[si]
    r = scene.sphere_radius[si]
    t_s = sphere_hit_one(origin, direction, c, r, t_min, BIG)
    v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
    t_t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
    t = torch.where(is_sph, t_s, t_t)
    p = point_at(origin, direction, t)
    _, n_s = sphere_normal(origin, direction, t, c, r)
    n = torch.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    mat = torch.where(is_sph, scene.sphere_mat[si], scene.tri_mat[ti])
    return t, p, n, mat


def trace_rays(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
               accel=None, intersect_fn: Optional[Callable] = None,
               return_stats: bool = False):
    """Trace R primary rays to completion; returns (R, 3) radiance.

    ``intersect_fn(scene, accel, origin, direction, t_min) -> (prim, t,
    hit)`` defaults to ``default_intersect``.  With ``return_stats=True``
    also returns ``segments``: (R,) int32 count of ray segments traced per
    path (the rays/s numerator).

    ``torch.autograd`` differentiates the result through the hit
    recompute, the scatter and the shading; primitive selection (the
    sweep) is not differentiated.  ``cfg.differentiable`` runs all
    ``max_depth + 1`` trips.
    """
    if intersect_fn is None:
        intersect_fn = default_intersect
    R = origin.shape[0]
    dev = origin.device
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    segments = torch.zeros((R,), dtype=torch.int32, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)

    for d in range(cfg.max_depth + 1):
        if not cfg.differentiable and not bool(alive.any()):
            break
        segments = segments + alive.to(torch.int32)
        with torch.no_grad():
            prim, _, hit = intersect_fn(scene, accel, origin, direction,
                                        cfg.t_min)
        t, p, n, mat = recompute_hit(scene, origin, direction, prim,
                                     cfg.t_min)
        # Dead and missing lanes get sanitized hit data so t = BIG points
        # cannot breed NaN/Inf.
        hit = hit & (t < BIG)
        p = torch.where(hit[:, None], p, 0.0)
        n = torch.where(hit[:, None], n, up)

        miss_now = alive & ~hit
        radiance = radiance + torch.where(
            miss_now[:, None], throughput * sky_color(direction), 0.0)

        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        new_dir, attenuation, scattered_ok = scatter(
            scene, mat, direction, p, n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)

        throughput = torch.where(cont[:, None], throughput * attenuation,
                                 throughput)
        origin = torch.where(cont[:, None], p, origin)
        direction = torch.where(cont[:, None], new_dir, direction)
        alive = cont

    if return_stats:
        return radiance, segments
    return radiance
