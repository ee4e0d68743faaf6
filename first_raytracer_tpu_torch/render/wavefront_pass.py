"""The wavefront pass past its closest hit: the shading and compaction
(K9) and the pool's regeneration (K10), and their plain versions.

A forward pass of the chunked batch (``render/integrator.py::trip``) or of
the regenerative pool (``render/regenerative.py::pool_pass``) is a closest
hit (K4, K5, K6 or the dense sweep), then two seams:

- ``shade``: the hit record re-solved from the winning primitive, the sky
  on a miss, the bounce's draw and the scatter, then whether each path goes
  on.  In trip mode (no ``start_id``) it updates the batch's carry in
  place.  In pool mode it adds each live slot's segment and sky to its
  output row and compacts the survivors' next states, in order, into the
  front of the pool in place; the slots past them keep what they held.  It
  writes the pass record (``record``: the survivors in all and the cursor
  as the pass found it).
- ``regenerate`` (pool mode only): the slots past the survivors refilled
  with camera rays from the id stream, and the cursor advanced, from the
  pass record.

On a CUDA device ``shade`` launches K9 and ``regenerate`` K10
(``kernels/csrc/wavefront_pass.cu``); each computes its part in registers,
the draw (K7's) and the camera rays (K8's, for the tail only) folded in,
and K9 takes the compaction's offsets from a single-pass scan with
decoupled look-back over the pool's ``scan`` words: bit-equal to the plain
versions as torch runs them on the card.  On the CPU they run
``shade_plain`` and ``regenerate_plain``, torch ops whose composition is
``pool_pass``' body as it was (a stable partition of the survivors, then
the tail), drawing through the plain Threefry and camera rays.  A tensor
on any other device is refused; a failed build or launch raises, and
nothing falls back.

The recorders and the occupancy scan run K12 (K13 folded into its pool
mode), from the same source (``diff/record_pass.py``), whose plain versions
share ``shade_slots``.  The differentiable ``_bounce`` (autograd,
``method="scan"``), the replays and the pool's init keep their torch
bodies.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.vecmath import constant
from ..materials.scatter import scatter
from .camera import _FIELDS, camera_rays_plain
from .integrator import (_CARRY, BIG, UP, recompute_hit, shade_carry,
                         sky_color)

__all__ = ["shade", "shade_plain", "shade_slots", "regenerate",
           "regenerate_plain", "pool_scratch", "BLOCK", "POOL_ROWS"]

REPLACES_SHADE = "first_raytracer_tpu/render/integrator.py:213"
REPLACES_REGENERATE = "first_raytracer_tpu/render/regenerative.py:87"
# Threads of a block of K9 and K10 (kThreads in the source): a tile of the
# scan, one status word each.
BLOCK = 256
# The pool's state that a pass moves: the compaction's rows.
POOL_ROWS = ("o", "d", "tp", "ids", "depth", "alive")


def pool_scratch(pool_size, device):
    """The pass record (``record``, (2,) int64: the survivors of the last
    pass and the cursor as it found it), which ``shade`` writes and
    ``regenerate`` reads, and K9's scan words (``scan``, int64: a ticket,
    then a status word a block of ``BLOCK`` slots; zero here, then left to
    K9, which tags each word with its pass, so nothing clears them)."""
    blocks = -(-pool_size // BLOCK)
    return dict(record=torch.zeros((2,), dtype=torch.int64, device=device),
                scan=torch.zeros((1 + blocks,), dtype=torch.int64,
                                 device=device))


def shade_slots(scene, cfg, key, ids, depth, o, d, prim, hit):
    """A pool's or recorder's slots past their closest hit, torch ops: the
    hit record re-solved from the primitive (the recompute the authority,
    ``hit & (t < BIG)``), the dead or missing lane sanitised (p = 0, n =
    UP), the draw of bounce ``depth`` and the scatter.  Returns ``(hit, p,
    new_dir, attenuation, ok)``."""
    t, p, n, mat = recompute_hit(scene, o, d, prim, cfg.t_min)
    hit = hit & (t < BIG)
    p = torch.where(hit[:, None], p, 0.0)
    n = torch.where(hit[:, None], n, constant(UP, torch.float32, o.device))
    new_dir, attenuation, ok = scatter(
        scene, mat, d, p, n, rng.uniforms_plain(key, ids, depth + 1))
    return hit, p, new_dir, attenuation, ok


def shade_plain(state, prim, hit, *, scene, key, cfg, start_id=None,
                num_rays=None):
    """K9's plain version, in place, torch ops on any device.  Trip mode
    (``start_id`` None): ``_bounce``'s body past the closest hit on
    ``trace_state``'s carry.  Pool mode: ``pool_pass``' body from the
    closest hit to the sky's ``index_add_``, then the survivors' next
    states compacted, in order, into the front of the pool (the slots past
    them keep what they held) and the pass record written."""
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
    o, d, tp, ids, depth, alive = (state[k] for k in POOL_ROWS)
    row = (ids - start_id).clamp(0, num_rays - 1)
    state["segments"].index_add_(0, row, alive.to(torch.int32))
    hit, p, new_dir, attenuation, ok = shade_slots(scene, cfg, key, ids,
                                                   depth, o, d, prim, hit)
    cont = alive & hit & ok & (depth < cfg.max_depth)

    # Rays that miss add the sky and end; the others end in black.
    state["out"].index_add_(0, row, torch.where(
        (alive & ~hit)[:, None], tp * sky_color(d), 0.0))

    # Compaction: a stable partition, survivors first; slot s < n_alive
    # takes the s-th survivor's next state.
    n_alive = cont.sum()
    slot = torch.arange(cont.shape[0], dtype=torch.int64, device=o.device)
    dest = torch.where(cont, torch.cumsum(cont, 0) - 1,
                       n_alive + torch.cumsum(~cont, 0) - 1)
    src = torch.empty_like(dest).index_copy_(0, dest, slot)
    front = slot < n_alive
    nexts = (p, new_dir, tp * attenuation, ids, depth + 1, cont)
    for k, v in zip(POOL_ROWS, nexts):
        keep = front[:, None] if v.dim() == 2 else front
        state[k].copy_(torch.where(keep, v[src], state[k]))
    state["record"].copy_(torch.stack([n_alive, state["cursor"]]))


def _fresh_rays_plain(camera, cfg, key, ids):
    """Camera rays for global ray ids (clamped into the image)."""
    ids = ids.clamp(0, cfg.num_rays - 1)
    return camera_rays_plain(camera, cfg.nx, cfg.ny, cfg.spp, key, ids)


def regenerate_plain(state, *, camera, key, start_id, cfg, num_rays,
                     pool_size, **_):
    """K10's plain version, in place, torch ops on any device: the slots
    past the pass record's survivors refilled from the primary stream at
    the record's cursor, and the cursor advanced."""
    C = pool_size
    o, d, tp, ids, depth, alive = (state[k] for k in POOL_ROWS)
    n_alive, cursor = state["record"]
    slot = torch.arange(C, dtype=torch.int64, device=o.device)
    is_tail = slot >= n_alive
    fresh_idx = cursor + slot - n_alive
    fresh_ids = start_id + fresh_idx.clamp(0, num_rays - 1)
    fo, fd = _fresh_rays_plain(camera, cfg, key, fresh_ids)
    tail = is_tail[:, None]
    o.copy_(torch.where(tail, fo, o))
    d.copy_(torch.where(tail, fd, d))
    tp.copy_(torch.where(tail, 1.0, tp))
    depth.copy_(torch.where(is_tail, 0, depth))
    ids.copy_(torch.where(is_tail, fresh_ids, ids))
    alive.copy_(torch.where(is_tail, fresh_idx < num_rays, alive))
    state["cursor"].copy_(cursor + torch.minimum(
        C - n_alive, (num_rays - cursor).clamp(min=0)))


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
        if R >= 2 ** 31:
            raise ValueError(f"a pool of {R} slots: K9's scan counts in "
                             "32 bits")
        names = (("o", f32, (R, 3)), ("d", f32, (R, 3)), ("tp", f32, (R, 3)),
                 ("ids", i64, (R,)), ("depth", i64, (R,)),
                 ("alive", b, (R,)), ("out", f32, (num_rays, 3)),
                 ("segments", torch.int32, (num_rays,)),
                 ("cursor", i64, ()), ("record", i64, (2,)),
                 ("scan", i64, (1 + -(-R // BLOCK),)))
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
            *(ptr[n] for n in POOL_ROWS),
            prim.data_ptr(), hit.data_ptr(), start_id.data_ptr(),
            int(num_rays), int(cfg.max_depth), float(cfg.t_min),
            *(ptr[n] for n in ("out", "segments", "cursor", "record",
                               "scan")), R)
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
    state, compacted, and its pass record.  Launches K9 for a CUDA state
    (float32 throughout) and runs ``shade_plain`` for a CPU one; bit-equal
    either way."""
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
    """K10 over the pool's tail, from K9's pass record, in place
    (``regenerate``): the tail's state and the advanced cursor.  Makes no
    host read, so a CUDA graph can capture it."""
    from ..kernels import megakernel

    f32, i64, b = torch.float32, torch.int64, torch.bool
    C = pool_size
    dev = state["alive"].device
    for name, dtype, shape in (
            ("o", f32, (C, 3)), ("d", f32, (C, 3)), ("tp", f32, (C, 3)),
            ("ids", i64, (C,)), ("depth", i64, (C,)), ("alive", b, (C,)),
            ("record", i64, (2,)), ("cursor", i64, ())):
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
        *(state[n].data_ptr() for n in POOL_ROWS),
        state["record"].data_ptr(), start_id.data_ptr(),
        state["cursor"].data_ptr(), int(num_rays), C)
    if C:
        regenerate.launches += 1


def regenerate(state, *, camera, key, start_id, cfg, num_rays, pool_size,
               **_):
    """The pool's regeneration, in place, from the pass record ``shade``
    wrote: launches K10 for a CUDA pool (a float32 camera on its device)
    and runs ``regenerate_plain`` for a CPU one; bit-equal either way."""
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
