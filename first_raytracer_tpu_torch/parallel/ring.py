"""Ring-sharded scene rendering: geometry split over the ranks of a mesh.

Port of ``first_raytracer_tpu.parallel.ring``.  When a scene is too large
to replicate on every device, its primitives are split along the
primitive axis over the mesh's tile axis, and the shards pass around a
ring each bounce while each rank's rays stay put (the ring-attention
dataflow: rays for queries, scene shards for key/value blocks, the running
closest hit for the running softmax state).  Materials are small and stay
replicated.

Each bounce resolves the global closest hit in ``n`` hops (``n`` the tile
axis's size): the rank's rays are swept against the shard it holds with
the port's dense closest hit (``kernels/dense_hit``: K11 on the card,
``intersect_brute`` on the CPU), the candidate is folded into a running
best (ties to the lower global primitive id, as the replicated sweep's
first minimum; a hop that misses everything never displaces the miss
sentinel), and the shard goes to rank ``r - 1`` while the shard of rank
``r + 1`` arrives (``MeshAxis.ring_shift``; the last hop sends nothing).
No rank ever holds the whole scene on its device.

The fold carries the winner's inputs (centre and radius, or vertices, and
material), not its hit record: the hit is recomputed once, after the
cycle, by the same arithmetic as ``render.integrator.recompute_hit``'s
mixed branch (``_recompute_from_carry``), so that each ray's hit equals
the replicated render's for the same winner.  The bounce loop's exit is
made uniform over the axis (``trace_rays(sync_axis=...)``): every rank
runs the same passes, or a rank would wait on a hop that never comes.

Shards must be of equal size, so the geometry is padded with primitives
that are never hit: zero-radius spheres far away and degenerate
triangles (``pad_scene_ring``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng
from ..core.vecmath import point_at
from ..geometry.sphere import BIG, sphere_hit_one, sphere_normal
from ..geometry.triangle import triangle_hit_one, triangle_normal
from ..render.api import pixel_means, render_rays
from ..kernels.dense_hit import dense_hit
from ..render.integrator import RenderConfig
from .mesh import TILE_AXIS, local_device

__all__ = ["pad_scene_ring", "shard_scene", "ring_closest_hit",
           "render_image_ring"]

_FAR = 1e30
# A shard travels as one float32 tensor: per sphere (cx, cy, cz, r, mat),
# per triangle (v0, v1, v2, mat); material ids are small integers, exact
# in float32.
_SPH_W, _TRI_W = 5, 10


def pad_scene_ring(scene, n_shards: int):
    """The scene with its sphere and triangle counts padded up to multiples
    of ``n_shards`` (at least one of each a shard) with sentinels: spheres
    of radius 0 at 1e30, triangles with three coincident vertices.  Neither
    can win a closest hit, so the padded scene renders the same image."""
    ns, nt = scene.num_spheres, scene.num_triangles

    def up(n):
        return -(-max(n, 1) // n_shards) * n_shards

    def cat(t, rows, fill):
        pad = torch.full((rows,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=t.device)
        return torch.cat([t, pad])

    rep = {}
    if up(ns) != ns:
        k = up(ns) - ns
        rep.update(sphere_center=cat(scene.sphere_center, k, _FAR),
                   sphere_radius=cat(scene.sphere_radius, k, 0.0),
                   sphere_mat=cat(scene.sphere_mat, k, 0))
    if up(nt) != nt:
        k = up(nt) - nt
        rep.update({f: cat(getattr(scene, f), k, 0.0)
                    for f in ("tri_v0", "tri_v1", "tri_v2")})
        rep["tri_mat"] = cat(scene.tri_mat, k, 0)
    return dataclasses.replace(scene, **rep)


def _pack_shard(s):
    """A shard's geometry as one flat float32 tensor."""
    sph = torch.cat([s.sphere_center, s.sphere_radius[:, None],
                     s.sphere_mat[:, None].float()], dim=1)
    tri = torch.cat([s.tri_v0, s.tri_v1, s.tri_v2,
                     s.tri_mat[:, None].float()], dim=1)
    return torch.cat([sph.reshape(-1), tri.reshape(-1)])


def _unpack_shard(scene, flat, ns, nt):
    """A shard from ``_pack_shard``'s flat tensor, each field contiguous
    (K11 reads the scene's tensors as they are)."""
    sph = flat[:ns * _SPH_W].reshape(ns, _SPH_W)
    tri = flat[ns * _SPH_W:].reshape(nt, _TRI_W)
    return dataclasses.replace(
        scene, sphere_center=sph[:, :3].contiguous(),
        sphere_radius=sph[:, 3].contiguous(),
        sphere_mat=sph[:, 4].to(scene.sphere_mat.dtype),
        tri_v0=tri[:, 0:3].contiguous(), tri_v1=tri[:, 3:6].contiguous(),
        tri_v2=tri[:, 6:9].contiguous(),
        tri_mat=tri[:, 9].to(scene.tri_mat.dtype))


def shard_scene(scene, n_shards: int, index: int):
    """Shard ``index`` of ``n_shards`` of the padded scene: its block of
    spheres and its block of triangles, the materials whole.  Returns
    ``(shard, padded sphere count)``; global triangle ids start at the
    padded sphere count."""
    padded = pad_scene_ring(scene, n_shards)
    ns, nt = (padded.num_spheres // n_shards,
              padded.num_triangles // n_shards)
    sph = slice(index * ns, (index + 1) * ns)
    tri = slice(index * nt, (index + 1) * nt)
    shard = dataclasses.replace(
        padded, sphere_center=padded.sphere_center[sph],
        sphere_radius=padded.sphere_radius[sph],
        sphere_mat=padded.sphere_mat[sph],
        **{f: getattr(padded, f)[tri]
           for f in ("tri_v0", "tri_v1", "tri_v2", "tri_mat")})
    return shard, padded.num_spheres


def ring_closest_hit(shard, axis, ns_total: int, origin, direction, t_min):
    """The global closest hit of rays ``origin + t direction`` over the
    shards of the ranks of ``axis`` (a ``MeshAxis``), this rank holding
    ``shard``: ``(best, gid)``, ``best`` a dict of the winners' carried
    inputs (``t``, ``is_sph``, ``c``, ``r``, ``v0``, ``v1``, ``v2``,
    ``mat``) and ``gid`` the global id of the padded scene (int32 max and
    t = BIG on a miss).  Every rank of the axis must call it together."""
    n, me = axis.size, axis.index
    ns, nt = shard.num_spheres, shard.num_triangles
    R, dev = origin.shape[0], origin.device
    f32 = torch.float32
    best = {
        "t": torch.full((R,), BIG, dtype=f32, device=dev),
        "gid": torch.full((R,), np.iinfo(np.int32).max, dtype=torch.int32,
                          device=dev),
        # A miss keeps the sentinel sphere (far centre, zero radius): the
        # recompute after the cycle then gives t = BIG, no hit.
        "is_sph": torch.ones((R,), dtype=torch.bool, device=dev),
        "c": torch.full((R, 3), _FAR, dtype=f32, device=dev),
        "r": torch.zeros((R,), dtype=f32, device=dev),
        "mat": torch.zeros((R,), dtype=shard.sphere_mat.dtype, device=dev),
        "v0": torch.zeros((R, 3), dtype=f32, device=dev),
        "v1": torch.zeros((R, 3), dtype=f32, device=dev),
        "v2": torch.zeros((R, 3), dtype=f32, device=dev),
    }
    flat = _pack_shard(shard)
    for h in range(n):
        block = (me + h) % n
        local = shard if h == 0 else _unpack_shard(shard, flat, ns, nt)
        # Selection only, the replicated sweep's arithmetic on this shard.
        lp, lt, _ = dense_hit(local, origin, direction, t_min)
        lp = lp.long()
        is_sph = lp < ns
        gid = torch.where(is_sph, block * ns + lp,
                          ns_total + block * nt + (lp - ns)).to(torch.int32)
        si, ti = lp.clamp(0, ns - 1), (lp - ns).clamp(0, nt - 1)
        cand = {"t": lt, "gid": gid, "is_sph": is_sph,
                "c": local.sphere_center[si], "r": local.sphere_radius[si],
                "mat": torch.where(is_sph, local.sphere_mat[si],
                                   local.tri_mat[ti]),
                "v0": local.tri_v0[ti], "v1": local.tri_v1[ti],
                "v2": local.tri_v2[ti]}
        better = (cand["t"] < best["t"]) | (
            (cand["t"] == best["t"]) & (cand["gid"] < best["gid"]))
        # A hop that misses everything reports t = BIG with a real id:
        # it never displaces the sentinel.
        better &= cand["t"] < BIG
        best = {k: torch.where(better[:, None] if v.dim() == 2 else better,
                               cand[k], v) for k, v in best.items()}
        if h + 1 < n:
            flat = axis.ring_shift(flat)
    return best, best["gid"]


def _recompute_from_carry(origin, direction, best, t_min):
    """``recompute_hit``'s mixed-branch arithmetic on the carried winner
    inputs, term for term: the hit equals the replicated render's for the
    same winner."""
    is_sph = best["is_sph"]
    c, r = best["c"], best["r"]
    v0, v1, v2 = best["v0"], best["v1"], best["v2"]
    t_s = sphere_hit_one(origin, direction, c, r, t_min, BIG)
    t_t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
    t = torch.where(is_sph, t_s, t_t)
    p = point_at(origin, direction, t)
    _, n_s = sphere_normal(origin, direction, t, c, r)
    n = torch.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    return t, p, n


def _ring_resolve(axis, ns_total):
    """The ``resolve_fn`` of ``trace_rays`` for a ring over ``axis``."""
    def resolve(shard, accel, origin, direction, t_min):
        del accel  # the shards move; no accel structure follows them
        with torch.no_grad():
            best, _ = ring_closest_hit(shard, axis, ns_total, origin,
                                       direction, t_min)
        t, p, n = _recompute_from_carry(origin, direction, best, t_min)
        return t, p, n, best["mat"], t < BIG

    return resolve


def render_image_ring(scene, camera, cfg: RenderConfig, mesh, seed: int = 0,
                      device="cuda"):
    """Full-image render with the scene ring-sharded over the mesh's tile
    axis; (ny, nx, 3) on ``device``, top row first, the whole image on
    every rank.

    Rays: a contiguous block of pixels a rank of the tile axis, all
    samples (ranks of another spp index repeat their tile's work).  Scene:
    this rank's shard of the padded geometry goes to ``device``, and the
    shards pass around the ring each bounce.  For the same seed the
    closest-hit selection equals the replicated render's, and each hit is
    recomputed as there.  Every rank of the mesh must call it;
    ``ValueError`` when the pixels do not divide over the tile axis.
    """
    axis = mesh.axis(TILE_AXIS)
    n = axis.size
    if cfg.num_pixels % n:
        raise ValueError(f"{cfg.num_pixels} pixels not divisible by {n} "
                         "shards")
    device = local_device(device)
    shard, ns_total = shard_scene(scene.to("cpu"), n, axis.index)
    shard, camera = shard.to(device), camera.to(device)
    per = cfg.num_pixels // n
    ids = torch.arange(axis.index * per * cfg.spp,
                       (axis.index + 1) * per * cfg.spp, dtype=torch.int64,
                       device=device)
    rad = render_rays(shard, camera, cfg, rng.base_key(seed), ids,
                      resolve_fn=_ring_resolve(axis, ns_total),
                      sync_axis=axis)
    img = axis.all_gather(pixel_means(rad, cfg.spp))
    return img.reshape(cfg.ny, cfg.nx, 3).flip(0)
