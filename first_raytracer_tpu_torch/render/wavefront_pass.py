"""The wavefront pass past its closest hit: the shading (K9) and the pool's
regeneration (K10), and their plain versions.

A forward pass of the chunked batch (``render/integrator.py::trip``) or of
the regenerative pool (``render/regenerative.py::pool_pass``) is a closest
hit (K4, K5, K6 or the dense sweep), then two seams:

- ``shade``: the hit record re-solved from the winning primitive, the sky
  on a miss, the bounce's draw and the scatter, then whether each path goes
  on.  In trip mode (no ``start_id``) it updates the batch's carry in
  place; in pool mode it adds each live slot's segment and sky to its
  output row, writes whether each slot goes on (``cont``) and the next
  state of those that do to the pool's scratch rows (``next_o``,
  ``next_d``, ``next_tp``, ``next_ids``, ``next_depth``).  ``regenerate``
  reads the rows of those slots only: the plain version writes every row,
  K9 leaves the rows of the slots that end as they were.
- ``regenerate`` (pool mode only): the survivors compacted to the front in
  order and the freed tail refilled with camera rays from the id stream.

On a CUDA device ``shade`` launches K9 and ``regenerate`` K10 and one
copy of the advanced cursor (``kernels/csrc/wavefront_pass.cu``); each
kernel computes its part in registers, the draw (K7's) and the camera
rays (K8's, for the tail only) folded in, and K10 takes the compaction's
scan from the survivor counts K9 writes a block: bit-equal to the plain
versions as torch runs them on the card.
On the CPU they run ``shade_plain`` and ``regenerate_plain``, the bodies
of ``_bounce`` and ``pool_pass`` as they were, split at these two seams,
drawing through the plain Threefry and camera rays.  A tensor on any other
device is refused; a failed build or launch raises, and nothing falls back.

The differentiable ``_bounce`` (autograd, ``method="scan"``), the
recorders, the replays and the pool's init keep their torch bodies.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.vecmath import constant
from ..materials.scatter import scatter
from .camera import _FIELDS, camera_rays_plain
from .integrator import (_CARRY, BIG, UP, recompute_hit, shade_carry,
                         sky_color)

__all__ = ["shade", "shade_plain", "regenerate", "regenerate_plain",
           "pool_scratch", "BLOCK", "NEXT_ROWS"]

REPLACES_SHADE = "first_raytracer_tpu/render/integrator.py:213"
REPLACES_REGENERATE = "first_raytracer_tpu/render/regenerative.py:87"
# Threads of a block of K9 and K10 (kThreads in the source): K9 counts each
# block's slots that continue, K10 takes its offsets from those counts.
BLOCK = 256
# The scratch rows of the next state, which hold a value only where
# ``cont`` is true once K9 has run.
NEXT_ROWS = ("next_o", "next_d", "next_tp", "next_ids", "next_depth")


def pool_scratch(pool_size, device):
    """The pool's scratch rows: the next state of each slot that goes on
    (``next_o``, ``next_d``, ``next_tp``, ``next_ids``, ``next_depth``),
    ``cont`` and its count a block of ``BLOCK`` slots (``block_counts``),
    and the advanced cursor K10 writes (``cursor_next``)."""
    C, f32, i64 = pool_size, torch.float32, torch.int64
    return dict(next_o=torch.zeros((C, 3), dtype=f32, device=device),
                next_d=torch.zeros((C, 3), dtype=f32, device=device),
                next_tp=torch.zeros((C, 3), dtype=f32, device=device),
                next_ids=torch.zeros((C,), dtype=i64, device=device),
                next_depth=torch.zeros((C,), dtype=i64, device=device),
                cont=torch.zeros((C,), dtype=torch.bool, device=device),
                block_counts=torch.zeros((-(-C // BLOCK),), dtype=torch.int32,
                                         device=device),
                cursor_next=torch.zeros((), dtype=i64, device=device))


def shade_plain(state, prim, hit, *, scene, key, cfg, start_id=None,
                num_rays=None):
    """K9's plain version, in place, torch ops on any device.  Trip mode
    (``start_id`` None): ``_bounce``'s body past the closest hit on
    ``trace_state``'s carry.  Pool mode: ``pool_pass``' body from the
    closest hit to the sky's ``index_add_``, its results written to every
    slot's scratch rows (``pool_scratch``)."""
    if start_id is None:
        resolved = (*recompute_hit(scene, state["origin"],
                                   state["direction"], prim, cfg.t_min),
                    hit)
        carry = shade_carry(
            scene, cfg, state["depth"], tuple(state[k] for k in _CARRY),
            resolved, rng.uniforms_plain(key, state["ray_ids"],
                                         state["depth"] + 1))
        for k, v in zip(_CARRY, carry):
            state[k].copy_(v)
        return
    o, d, tp, ids, depth, alive = (state[k] for k in (
        "o", "d", "tp", "ids", "depth", "alive"))
    row = (ids - start_id).clamp(0, num_rays - 1)
    state["segments"].index_add_(0, row, alive.to(torch.int32))
    t, p, n, mat = recompute_hit(scene, o, d, prim, cfg.t_min)
    hit = hit & (t < BIG)
    p = torch.where(hit[:, None], p, 0.0)
    n = torch.where(hit[:, None], n, constant(UP, torch.float32, o.device))
    new_dir, attenuation, ok = scatter(
        scene, mat, d, p, n, rng.uniforms_plain(key, ids, depth + 1))
    cont = alive & hit & ok & (depth < cfg.max_depth)

    # Rays that miss add the sky and end; the others end in black.
    state["out"].index_add_(0, row, torch.where(
        (alive & ~hit)[:, None], tp * sky_color(d), 0.0))
    for k, v in (("next_o", p), ("next_d", new_dir),
                 ("next_tp", tp * attenuation), ("next_ids", ids),
                 ("next_depth", depth + 1), ("cont", cont)):
        state[k].copy_(v)


def _fresh_rays_plain(camera, cfg, key, ids):
    """Camera rays for global ray ids (clamped into the image)."""
    ids = ids.clamp(0, cfg.num_rays - 1)
    return camera_rays_plain(camera, cfg.nx, cfg.ny, cfg.spp, key, ids)


def regenerate_plain(state, *, camera, key, start_id, cfg, num_rays,
                     pool_size, **_):
    """K10's plain version, in place, torch ops on any device:
    ``pool_pass``' compaction and regeneration from the scratch rows that
    ``shade`` wrote."""
    C = pool_size
    o, d, tp, ids, depth, alive = (state[k] for k in (
        "o", "d", "tp", "ids", "depth", "alive"))
    cont = state["cont"]
    # Compaction: survivors in order to the front, the dead after them.
    n_alive = cont.sum()
    slot = torch.arange(C, dtype=torch.int64, device=o.device)
    dest = torch.where(cont, torch.cumsum(cont, 0) - 1,
                       n_alive + torch.cumsum(~cont, 0) - 1)
    src = torch.empty_like(dest).index_copy_(0, dest, slot)

    # Regeneration: the tail from the primary stream.
    cursor = state["cursor"]
    is_tail = slot >= n_alive
    fresh_idx = cursor + slot - n_alive
    fresh_ids = start_id + fresh_idx.clamp(0, num_rays - 1)
    fo, fd = _fresh_rays_plain(camera, cfg, key, fresh_ids)
    tail = is_tail[:, None]
    o.copy_(torch.where(tail, fo, state["next_o"][src]))
    d.copy_(torch.where(tail, fd, state["next_d"][src]))
    tp.copy_(torch.where(tail, 1.0, state["next_tp"][src]))
    depth.copy_(torch.where(is_tail, 0, state["next_depth"][src]))
    ids.copy_(torch.where(is_tail, fresh_ids, state["next_ids"][src]))
    alive.copy_(~is_tail | (fresh_idx < num_rays))
    cursor.add_(torch.minimum(C - n_alive, (num_rays - cursor).clamp(min=0)))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, expected {dtype} {tuple(shape)} on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _scene_args(scene, dev):
    """K9's scene arguments: the scene's tensors (float32 and int32 on
    ``dev``, contiguous) and their counts."""
    ns, nt, nm = scene.num_spheres, scene.num_triangles, scene.num_materials
    if ns + nt == 0:
        raise ValueError("K9 needs a scene with a primitive")
    f32, i32 = torch.float32, torch.int32
    for name, dtype, shape in (
            ("sphere_center", f32, (ns, 3)), ("sphere_radius", f32, (ns,)),
            ("sphere_mat", i32, (ns,)), ("tri_v0", f32, (nt, 3)),
            ("tri_v1", f32, (nt, 3)), ("tri_v2", f32, (nt, 3)),
            ("tri_mat", i32, (nt,)), ("mat_type", i32, (nm,)),
            ("tex_type", i32, (nm,)), ("albedo", f32, (nm, 3)),
            ("albedo2", f32, (nm, 3)), ("tex_scale", f32, (nm,)),
            ("fuzz", f32, (nm,)), ("ref_idx", f32, (nm,))):
        _check(f"scene.{name}", getattr(scene, name), dtype, shape, dev)
    tensors = [scene.sphere_center, scene.sphere_radius, scene.sphere_mat,
               scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_mat]
    table = [scene.mat_type, scene.tex_type, scene.albedo, scene.albedo2,
             scene.tex_scale, scene.fuzz, scene.ref_idx]
    return ([t.data_ptr() for t in tensors] + [ns, nt]
            + [t.data_ptr() for t in table] + [nm])


def _hits(prim, hit, R, dev):
    """The closest hit's primitives as int32 and hits as bool, (R,)."""
    if prim.dtype != torch.int32:
        prim = prim.to(torch.int32)
    _check("prim", prim.contiguous(), torch.int32, (R,), dev)
    _check("hit", hit.contiguous(), torch.bool, (R,), dev)
    return prim.contiguous(), hit.contiguous()


def _launch_shade(state, prim, hit, *, scene, key, cfg, start_id=None,
                  num_rays=None):
    """K9 over the state's slots, in place (``shade``).  Makes no host
    read and allocates only a cast of ``prim``, so a CUDA graph can capture
    it."""
    from ..kernels import megakernel

    f32, i64, b = torch.float32, torch.int64, torch.bool
    pool = start_id is not None
    dev = state["alive"].device
    R = state["alive"].shape[0]
    if pool:
        names = (("o", f32, (R, 3)), ("d", f32, (R, 3)), ("tp", f32, (R, 3)),
                 ("ids", i64, (R,)), ("depth", i64, (R,)),
                 ("alive", b, (R,)), ("out", f32, (num_rays, 3)),
                 ("segments", torch.int32, (num_rays,)),
                 ("next_o", f32, (R, 3)), ("next_d", f32, (R, 3)),
                 ("next_tp", f32, (R, 3)), ("next_ids", i64, (R,)),
                 ("next_depth", i64, (R,)), ("cont", b, (R,)),
                 ("block_counts", torch.int32, (-(-R // BLOCK),)))
    else:
        names = (("origin", f32, (R, 3)), ("direction", f32, (R, 3)),
                 ("throughput", f32, (R, 3)), ("radiance", f32, (R, 3)),
                 ("alive", b, (R,)), ("segments", torch.int32, (R,)),
                 ("ray_ids", i64, (R,)), ("depth", i64, ()))
    for name, dtype, shape in names:
        _check(f"state[{name!r}]", state[name], dtype, shape, dev)
    prim, hit = _hits(prim, hit, R, dev)
    k = rng.device_key(key, dev)
    scene_args = _scene_args(scene, dev)
    ptr = {name: state[name].data_ptr() for name, _, _ in names}
    if pool:
        _check("start_id", start_id, i64, (), dev)
        megakernel.launch_entry(
            dev, "frt_shade_pool", k.data_ptr(), *scene_args,
            *(ptr[n] for n in ("o", "d", "tp", "ids", "depth", "alive")),
            prim.data_ptr(), hit.data_ptr(), start_id.data_ptr(),
            int(num_rays), int(cfg.max_depth), float(cfg.t_min),
            *(ptr[n] for n in ("out", "segments", "next_o", "next_d",
                               "next_tp", "next_ids", "next_depth",
                               "cont", "block_counts")), R)
    else:
        megakernel.launch_entry(
            dev, "frt_shade_trip", k.data_ptr(), *scene_args,
            *(ptr[n] for n in ("origin", "direction", "throughput",
                               "radiance", "alive", "segments", "ray_ids",
                               "depth")),
            prim.data_ptr(), hit.data_ptr(), int(cfg.max_depth),
            float(cfg.t_min), R)
    if R:
        shade.launches += 1


def shade(state, prim, hit, *, scene, key, cfg, start_id=None,
          num_rays=None):
    """The pass past its closest hit ``(prim, hit)``, in place: trip mode
    on ``trace_state``'s carry, or pool mode (``start_id``, the pool's
    first id as a 0-d int64 tensor, and ``num_rays``) on ``pool_state``'s
    state and scratch rows.  Launches K9 for a CUDA state (float32
    throughout) and runs ``shade_plain`` for a CPU one; bit-equal either
    way."""
    dev = state["alive"].device
    if dev.type == "cpu":
        return shade_plain(state, prim, hit, scene=scene, key=key, cfg=cfg,
                           start_id=start_id, num_rays=num_rays)
    if dev.type != "cuda":
        raise ValueError(f"no shading kernel for device {dev}")
    return _launch_shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start_id, num_rays=num_rays)


shade.launches = 0  # K9 launches (CUDA path only)


def _launch_regenerate(state, *, camera, key, start_id, cfg, num_rays,
                       pool_size):
    """K10 over the pool's slots, from K9's scratch rows and block
    counts, in place (``regenerate``): the state, and the advanced cursor
    written to ``cursor_next`` and then copied into ``cursor``.  Makes no
    host read, so a CUDA graph can capture it."""
    from ..kernels import megakernel

    f32, i64, b = torch.float32, torch.int64, torch.bool
    C = pool_size
    dev = state["alive"].device
    for name, dtype, shape in (
            ("o", f32, (C, 3)), ("d", f32, (C, 3)), ("tp", f32, (C, 3)),
            ("ids", i64, (C,)), ("depth", i64, (C,)), ("alive", b, (C,)),
            ("cursor", i64, ()), ("next_o", f32, (C, 3)),
            ("next_d", f32, (C, 3)), ("next_tp", f32, (C, 3)),
            ("next_ids", i64, (C,)), ("next_depth", i64, (C,)),
            ("cont", b, (C,)),
            ("block_counts", torch.int32, (-(-C // BLOCK),)),
            ("cursor_next", i64, ())):
        _check(f"state[{name!r}]", state[name], dtype, shape, dev)
    _check("start_id", start_id, i64, (), dev)
    fields = [getattr(camera, f) for f in _FIELDS]
    for name, t in zip(_FIELDS, fields):
        if t.requires_grad:
            raise ValueError(f"camera.{name} requires grad: K10 has no "
                             "gradient")
        _check(f"camera.{name}", t, f32,
               () if name == "lens_radius" else (3,), dev)
    if min(cfg.nx, cfg.ny, cfg.spp) < 1:
        raise ValueError(f"bad image size {cfg.nx}x{cfg.ny}@{cfg.spp}")
    k = rng.device_key(key, dev)
    megakernel.launch_entry(
        dev, "frt_regenerate", k.data_ptr(), *(t.data_ptr() for t in fields),
        int(cfg.nx), int(cfg.ny), int(cfg.spp),
        *(state[n].data_ptr() for n in (
            "o", "d", "tp", "ids", "depth", "alive", "next_o", "next_d",
            "next_tp", "next_ids", "next_depth", "cont", "block_counts",
            "cursor")),
        start_id.data_ptr(), state["cursor_next"].data_ptr(), int(num_rays),
        C)
    if C:
        regenerate.launches += 1
    state["cursor"].copy_(state["cursor_next"])


def regenerate(state, *, camera, key, start_id, cfg, num_rays, pool_size,
               **_):
    """The pool's compaction and regeneration, in place, from the scratch
    rows ``shade`` wrote: launches K10 for a CUDA pool (a float32 camera on
    its device) and runs ``regenerate_plain`` for a CPU one; bit-equal
    either way."""
    dev = state["alive"].device
    if dev.type == "cpu":
        return regenerate_plain(state, camera=camera, key=key,
                                start_id=start_id, cfg=cfg,
                                num_rays=num_rays, pool_size=pool_size)
    if dev.type != "cuda":
        raise ValueError(f"no regeneration kernel for device {dev}")
    return _launch_regenerate(state, camera=camera, key=key,
                              start_id=start_id, cfg=cfg, num_rays=num_rays,
                              pool_size=pool_size)


regenerate.launches = 0  # K10 launches (CUDA path only)
