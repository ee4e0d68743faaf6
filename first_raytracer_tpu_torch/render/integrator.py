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
the dense all-pairs sweep without an accel (K11, ``kernels/dense_hit``, on
a CUDA device; ``intersect_brute``, its plain version, on the CPU) and
dispatches on the accel's type otherwise: K4 (``kernels/intersect_pallas``),
K5 (``kernels/intersect_clustered``) or K6, the flat-BVH walk
(``accel/traverse``).  The hit record is then recomputed from the winning
primitive (``recompute_hit``), which is the authority on whether it really
hits, so gradients flow through the hit equation whatever found the
primitive.  This is the port's CPU-runnable yardstick for the megakernel
(``kernels/megakernel.py``).  ``resolve_fn`` replaces the closest hit and
its recompute together (the ring-sharded scene of ``parallel/ring.py``
assembles them over hops between ranks), and ``sync_axis`` makes the
early exit uniform over a mesh axis, so that every rank runs the same
passes and a collective inside a pass cannot deadlock.

The forward path is the JAX package's ``while_loop``: ``trip`` advances a
state of fixed shape (``trace_state``) by one trip in place, the depth a
0-d device tensor, and the host reads "any ray alive" once per block of
trips; on a CUDA device the blocks replay as a CUDA graph
(``render/graphed.py``).  Past its closest hit a trip is
``render/wavefront_pass.shade``: K9, one kernel, on a CUDA device, and
``_bounce``'s body (``shade_carry``) on the CPU.  The differentiable
path, ``resolve_fn`` and ``sync_axis`` run one trip at a time, eagerly;
the differentiable path's value and gradient is captured whole as a CUDA
graph by ``diff.grad.render_loss_and_grads_scan``.  Its trips re-solve
their hits from the scene's row tables (``scene/payload.py::row_tables``,
built once a call; ``recompute_hit_rows``), whose rows a trip gathers in
one ``kernels.gather_rows`` call: K16 on a CUDA device, and K17, a row sum
in a fixed order, for their gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core import rng
from ..core.vecmath import constant, point_at
from ..geometry.sphere import (BIG, sphere_hit_all, sphere_hit_one,
                               sphere_normal)
from ..geometry.triangle import (triangle_hit_all, triangle_hit_one,
                                 triangle_normal)
from ..kernels.gather_rows import gather_rows
from ..materials.scatter import scatter, scatter_rows
from ..scene.payload import row_tables

__all__ = ["RenderConfig", "default_intersect", "forward_trips",
           "intersect_brute", "recompute_hit", "recompute_hit_rows",
           "shade_carry", "sky_color",
           "trace_rays", "trace_state", "trip"]


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
# The normal given to a lane without a hit, so that its shading stays finite.
UP = (0.0, 0.0, 1.0)


def sky_color(direction):
    """Miss shader: vertical white -> blue lerp; (R, 3)."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = constant(_WHITE, torch.float32, direction.device)
    blue = constant(_BLUE, torch.float32, direction.device)
    return (1.0 - t)[:, None] * white + t[:, None] * blue


@torch.no_grad()
def default_intersect(scene, accel, origin, direction, t_min, alive=None):
    """Closest hit by the accel's type: K11, the dense sweep (None), K5
    (``ClusteredScenePack``), K4 (``PallasScenePack``) or K6, the flat-BVH
    walk (``FlatBVH``); each kernel's plain version on the CPU.  Runs
    without autograd: it only finds the primitive.  ``alive``, the rays'
    (R,) bool liveness, goes to K11 only, which gives a dead ray the miss
    without sweeping it; K4, K5 and K6 sweep every ray."""
    if accel is None:
        from ..kernels.dense_hit import dense_hit
        return dense_hit(scene, origin, direction, t_min, alive)
    from ..kernels.intersect_clustered import (ClusteredScenePack,
                                               intersect_clustered)
    if isinstance(accel, ClusteredScenePack):
        return intersect_clustered(scene, accel, origin, direction, t_min)
    from ..kernels.intersect_pallas import PallasScenePack, intersect_pallas
    if isinstance(accel, PallasScenePack):
        return intersect_pallas(scene, accel, origin, direction, t_min)
    from ..accel.traverse import intersect_bvh
    return intersect_bvh(scene, accel, origin, direction, t_min)


default_intersect.takes_alive = True


def closest_hit(intersect_fn, scene, accel, origin, direction, t_min,
                alive):
    """A loop body's closest hit through ``intersect_fn``: one marked
    ``takes_alive`` (``default_intersect``, the scan's ``_resolver``) also
    gets the rays' liveness, so that K11 sweeps only the live rays and
    gives the others the miss; any other is called with its five
    arguments.  The bodies that call it read a dead ray's (prim, hit) only
    under ``alive``."""
    if getattr(intersect_fn, "takes_alive", False):
        return intersect_fn(scene, accel, origin, direction, t_min,
                            alive=alive)
    return intersect_fn(scene, accel, origin, direction, t_min)


def intersect_brute(scene, origin, direction, t_min):
    """Dense closest hit over every (ray, primitive) pair: K11's plain
    version (``kernels/dense_hit.py``), torch ops on any device.

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


def _prim_ids(scene, prim):
    """The clamped sphere and triangle ids of ``prim`` (None where the
    scene has no such primitive), whether each hit is a sphere's (None
    unless the scene has both) and its material id."""
    ns, nt = scene.num_spheres, scene.num_triangles
    prim = prim.long()
    si = torch.clamp(prim, 0, ns - 1) if ns else None
    ti = torch.clamp(prim - ns, 0, nt - 1) if nt else None
    if nt == 0:
        return si, None, None, scene.sphere_mat[si]
    if ns == 0:
        return None, ti, None, scene.tri_mat[ti]
    is_sph = prim < ns
    return si, ti, is_sph, torch.where(is_sph, scene.sphere_mat[si],
                                       scene.tri_mat[ti])


def _hit_record(origin, direction, t_min, is_sph, sphere, triangle):
    """(t, p, n) re-solved on each ray's gathered sphere ``(c, r)`` or
    triangle ``(v0, v1, v2)`` (None where the scene has none), picked by
    ``is_sph`` where it has both."""
    if triangle is None:
        c, r = sphere
        t = sphere_hit_one(origin, direction, c, r, t_min, BIG)
        p, n = sphere_normal(origin, direction, t, c, r)
        return t, p, n
    v0, v1, v2 = triangle
    t_t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
    if sphere is None:
        return (t_t, point_at(origin, direction, t_t),
                triangle_normal(v0, v1, v2))
    c, r = sphere
    t_s = sphere_hit_one(origin, direction, c, r, t_min, BIG)
    t = torch.where(is_sph, t_s, t_t)
    p = point_at(origin, direction, t)
    _, n_s = sphere_normal(origin, direction, t, c, r)
    n = torch.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    return t, p, n


def recompute_hit(scene, origin, direction, prim, t_min):
    """Hit record ``(t, p, n, mat_id)`` re-solved from the primitive id."""
    si, ti, is_sph, mat = _prim_ids(scene, prim)
    sphere = triangle = None
    if si is not None:
        sphere = scene.sphere_center[si], scene.sphere_radius[si]
    if ti is not None:
        triangle = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
    return (*_hit_record(origin, direction, t_min, is_sph, sphere,
                         triangle), mat)


def recompute_hit_rows(scene, tables, origin, direction, prim, t_min):
    """``recompute_hit`` on the scene's row tables
    (``scene/payload.py::row_tables``): ``(t, p, n, rows)``, ``rows`` the
    hits' (R, 11) material rows, the same values.  The rays' sphere,
    triangle and material rows come from one ``kernels.gather_rows`` call
    (K16 on a CUDA device), whose backward sums each table row's gradient
    over the rays that read it in a fixed order (K17)."""
    si, ti, is_sph, mat = _prim_ids(scene, prim)
    sph, tri, mats = tables
    picked = [(t, i) for t, i in ((sph, si), (tri, ti), (mats, mat.long()))
              if i is not None]
    rows = list(gather_rows(tuple(t for t, _ in picked),
                            tuple(i for _, i in picked)))
    sphere = triangle = None
    if si is not None:
        g = rows.pop(0)
        sphere = g[:, 0:3], g[:, 3]
    if ti is not None:
        g = rows.pop(0)
        triangle = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    return (*_hit_record(origin, direction, t_min, is_sph, sphere,
                         triangle), rows[0])


def _any_alive(alive, sync_axis):
    """Whether any ray is alive: here, or on any rank of ``sync_axis``."""
    if sync_axis is None:
        return bool(alive.any())
    count = alive.sum(dtype=torch.int32).reshape(1)
    return int(sync_axis.all_reduce(count)) > 0


def _resolver(intersect_fn, tables=None):
    """``resolve_fn`` from an ``intersect_fn``: the closest hit without
    autograd (``closest_hit``, given the rays' liveness), then the hit
    record recomputed from its primitive: from the scene's tensors, or with
    ``tables`` (``scene/payload.py::row_tables``) from their rows
    (``recompute_hit_rows``, the material as its row)."""
    def resolve_fn(scene, accel, origin, direction, t_min, alive):
        with torch.no_grad():
            prim, _, hit = closest_hit(intersect_fn, scene, accel, origin,
                                       direction, t_min, alive)
        if tables is None:
            record = recompute_hit(scene, origin, direction, prim, t_min)
        else:
            record = recompute_hit_rows(scene, tables, origin, direction,
                                        prim, t_min)
        return (*record, hit)
    resolve_fn.takes_alive = True
    return resolve_fn


_CARRY = ("origin", "direction", "throughput", "radiance", "alive",
          "segments")


def _bounce(scene, accel, resolve_fn, key, ray_ids, cfg, d, carry):
    """One trip of every ray at depth ``d`` (a Python int or a 0-d device
    tensor): the carry ``_CARRY`` in, the next carry out.  A trip in which
    every ray is dead changes nothing.  ``_resolver``'s ``resolve_fn`` is
    given the carry's ``alive`` (K11 then sweeps only the live rays and
    gives the dead ones the miss); a caller's keeps its five arguments."""
    resolved = closest_hit(resolve_fn, scene, accel, carry[0], carry[1],
                           cfg.t_min, carry[4])
    return shade_carry(scene, cfg, d, carry, resolved,
                       rng.bounce_uniforms(key, ray_ids, d))


def shade_carry(scene, cfg, d, carry, resolved, uniforms):
    """``_bounce`` past its closest hit: the carry ``_CARRY`` at depth
    ``d``, the hit record ``resolved`` (t, p, n, mat, hit; ``mat`` the
    (R,) material ids, or the hits' (R, 11) material rows of
    ``recompute_hit_rows``) and the bounce's (R, 4) uniforms in, the next
    carry out."""
    origin, direction, throughput, radiance, alive, segments = carry
    segments = segments + alive.to(torch.int32)
    t, p, n, mat, hit = resolved
    # Dead and missing lanes get sanitized hit data so t = BIG points
    # cannot breed NaN/Inf.
    hit = hit & (t < BIG)
    p = torch.where(hit[:, None], p, 0.0)
    n = torch.where(hit[:, None], n, constant(UP, torch.float32,
                                              origin.device))

    miss_now = alive & ~hit
    radiance = radiance + torch.where(
        miss_now[:, None], throughput * sky_color(direction), 0.0)

    if mat.dim() == 2:
        new_dir, attenuation, scattered_ok = scatter_rows(
            mat, direction, p, n, uniforms)
    else:
        new_dir, attenuation, scattered_ok = scatter(
            scene, mat, direction, p, n, uniforms)
    cont = alive & hit & scattered_ok & (d < cfg.max_depth)

    throughput = torch.where(cont[:, None], throughput * attenuation,
                             throughput)
    origin = torch.where(cont[:, None], p, origin)
    direction = torch.where(cont[:, None], new_dir, direction)
    return origin, direction, throughput, radiance, cont, segments


def trace_state(origin, direction, ray_ids, **_):
    """The forward trips' state at depth 0: ``_CARRY``, the ray ids and
    the depth as a 0-d int64 tensor, every tensor the state's own."""
    R, dev = origin.shape[0], origin.device
    return dict(origin=origin.clone(), direction=direction.clone(),
                throughput=torch.ones((R, 3), dtype=torch.float32,
                                      device=dev),
                radiance=torch.zeros((R, 3), dtype=torch.float32,
                                     device=dev),
                alive=torch.ones((R,), dtype=torch.bool, device=dev),
                segments=torch.zeros((R,), dtype=torch.int32, device=dev),
                depth=torch.zeros((), dtype=torch.int64, device=dev),
                ray_ids=ray_ids.clone())


@torch.no_grad()
def trip(state, *, scene, accel, key, cfg, intersect_fn, **_):
    """One forward trip of ``trace_state``'s state, in place: the body of
    the JAX package's ``while_loop`` (``integrator.py:255-268``), the
    depth on the device and no host read, so that a CUDA graph captures
    it; past the depth cap or once every ray is dead it changes nothing.
    The closest hit, then ``render.wavefront_pass.shade``: K9 on a CUDA
    device, ``shade_plain`` (``_bounce``'s body) on the CPU."""
    from .wavefront_pass import shade
    prim, _, hit = closest_hit(intersect_fn, scene, accel, state["origin"],
                               state["direction"], cfg.t_min, state["alive"])
    shade(state, prim, hit, scene=scene, key=key, cfg=cfg)
    state["depth"].add_(1)


def trace_rays(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
               accel=None, intersect_fn: Optional[Callable] = None,
               return_stats: bool = False,
               resolve_fn: Optional[Callable] = None, sync_axis=None,
               graphed: Optional[bool] = None):
    """Trace R primary rays to completion; returns (R, 3) radiance.

    ``intersect_fn(scene, accel, origin, direction, t_min) -> (prim, t,
    hit)`` defaults to ``default_intersect``.  With ``return_stats=True``
    also returns ``segments``: (R,) int32 count of ray segments traced per
    path (the rays/s numerator).

    The forward path runs ``trip`` in blocks of
    ``render.graphed.PASSES_PER_READ`` trips, one read of "any ray alive"
    per block; on a CUDA device as CUDA graphs
    (``render.graphed.LOOPS``) unless ``graphed=False``
    (``render.graphed.graphed_route``).

    ``resolve_fn(scene, accel, origin, direction, t_min) -> (t, p, n, mat,
    hit)``, when given, replaces the whole closest-hit resolution
    (``intersect_fn`` and ``recompute_hit``).  ``sync_axis``, a
    ``parallel.mesh.MeshAxis``, turns the forward path's exit once every
    ray is dead into an all-reduce of the alive count over that axis, so
    that every rank of it runs the same number of passes.  Both run
    eagerly, one trip at a time.

    ``torch.autograd`` differentiates the result through the hit
    recompute, the scatter and the shading; primitive selection (the
    sweep) is not differentiated.  ``cfg.differentiable`` runs all
    ``max_depth + 1`` trips, unrolled with the depth a Python int (so the
    draw's domain is a launch argument), eagerly; each trip's closest hit
    is given the rays' liveness (``closest_hit``), and without a
    ``resolve_fn`` its hit record and material come from the scene's row
    tables (``recompute_hit_rows``: K16, and K17 for the gradient).
    """
    if intersect_fn is None:
        intersect_fn = default_intersect
    if not (cfg.differentiable or resolve_fn or sync_axis):
        out = forward_trips(trace_state, dict(
            scene=scene, accel=accel, key=key, origin=origin,
            direction=direction, ray_ids=ray_ids), cfg, intersect_fn,
            graphed)
        return out if return_stats else out[0]
    if resolve_fn is None:
        # The differentiable trips take their rows from the tables, built
        # once a call, so that their gathers' gradient is K17's sum.
        resolve_fn = _resolver(intersect_fn, row_tables(scene)
                               if cfg.differentiable else None)
    R = origin.shape[0]
    dev = origin.device
    carry = (origin, direction,
             torch.ones((R, 3), dtype=torch.float32, device=dev),
             torch.zeros((R, 3), dtype=torch.float32, device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev),
             torch.zeros((R,), dtype=torch.int32, device=dev))
    for d in range(cfg.max_depth + 1):
        if not cfg.differentiable and not _any_alive(carry[4], sync_axis):
            break
        carry = _bounce(scene, accel, resolve_fn, key, ray_ids, cfg, d,
                        carry)
    if return_stats:
        return carry[3], carry[5]
    return carry[3]


@torch.no_grad()
def forward_trips(init, inputs, cfg, intersect_fn, graphed):
    """(radiance, segments) of the forward trips from ``init``'s state,
    through ``render.graphed.run_loop``."""
    from .graphed import run_loop
    out = run_loop(init, trip, dict(cfg=cfg, intersect_fn=intersect_fn),
                   inputs, inputs["ray_ids"].device, ("radiance", "segments"),
                   graphed)
    return out["radiance"], out["segments"]
