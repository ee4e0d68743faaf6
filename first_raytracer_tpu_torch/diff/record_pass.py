"""The recorders' pass past the closest hit (K12, with the pool recorder's
regeneration, K13, folded into its pool mode), and their plain versions.

A bounce of the lockstep recorder (``diff/replay.py::record_bounce``), a
bounce of the occupancy scan (``utils/metrics.py::_length_pass``) and a
pass of the pool recorder (``record_pool_pass``) are a closest hit (K11,
K4, K5 or K6) and then these seams:

- ``record_step`` (lockstep and length modes): the hit record re-solved
  from the winning primitive (the recompute is the authority: ``hit & (t <
  BIG)``), the bounce's draw at the device's bounce counter ``d`` and the
  scatter; the tape's row ``min(d, max_depth + 1)`` written whole (the id
  where the ray was alive and hit, else -1) when the state has a ``tape``,
  each ray's ``length`` counting the bounces it entered alive when it has
  one; the rays and ``alive`` updated in place; and ``d`` advanced by one.
  K12 advances it itself (its last block to arrive on the state's
  ``arrivals`` word adds one), so a bounce is two graph nodes.
- ``record_shade`` (pool mode): the same shading per slot at the slot's own
  depth, the hit's entry ``depth * R + col`` of the flat tape, the
  survivors' next states compacted, in order, into the front of the pool
  in place and the pass record (``record``: the survivors in all and the
  cursor as the pass found it); then the slots past the survivors refilled
  with the camera rays of the stream's next ids, and the cursor advanced.

On a CUDA device ``record_step`` launches K12 in lockstep or length mode
and ``record_shade`` K12 in pool mode, one launch that also refills the
tail (``kernels/csrc/wavefront_pass.cu``, beside K9 and K10, whose shading,
draw and look-back they share): bit-equal to the plain versions as torch
runs them on the card.  On the CPU they run ``record_step_plain``, and
``record_shade_plain`` then ``record_regenerate_plain``: torch ops that
draw through the plain Threefry and camera rays, which compose to the pool
recorder's body as it was (a stable partition of the survivors, then the
tail).  A tensor on any other device is refused; a failed build or launch
raises, and nothing falls back.  The wrappers make no host read and
allocate nothing but a cast of ``prim``, so ``render/graphed.py::
run_loop`` captures them.

One difference the tape never shows: the plain pool scatters the lanes
that write nothing to the flat tape's last entry, which the recorder
slices off; K12 writes nothing for them.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..render.camera import _FIELDS, camera_rays_plain
from ..render.wavefront_pass import _check, _hits, _scene_args, shade_slots

__all__ = ["record_step", "record_step_plain", "record_shade",
           "record_shade_plain", "record_regenerate_plain", "record_scratch",
           "RECORD_ROWS", "RECORD_TILE", "STEP_WINDOW", "REPLACES_STEP",
           "REPLACES_LENGTH", "REPLACES_POOL"]

REPLACES_STEP = "first_raytracer_tpu/diff/replay.py:92"
REPLACES_LENGTH = "first_raytracer_tpu/utils/metrics.py:29"
REPLACES_POOL = "first_raytracer_tpu/diff/replay.py:155"
# The pool recorder's state that a pass moves: the compaction's rows.
RECORD_ROWS = ("o", "d", "ids", "col", "depth", "alive")
# Rays a block of K12's lockstep and length modes takes (kStepWindow in the
# source): the window whose live rays it packs.
STEP_WINDOW = 256
# Slots a tile of K12's pool-mode scan (kRecordTile in the source), one
# status word each.
RECORD_TILE = 256


def record_scratch(pool_size, device):
    """The pool recorder's pass record (``record``, (2,) int64: the
    survivors of the last pass and the cursor as it found it) and K12's
    scan words (``scan``, int64: a ticket, then a status word a tile of
    ``RECORD_TILE`` slots; zero here, then left to K12, which tags each
    word with its pass, so nothing clears them)."""
    tiles = -(-pool_size // RECORD_TILE)
    return dict(record=torch.zeros((2,), dtype=torch.int64, device=device),
                scan=torch.zeros((1 + tiles,), dtype=torch.int64,
                                 device=device))


def record_step_plain(state, prim, hit, *, scene, key, ray_ids, cfg):
    """K12's plain version in lockstep and length modes, in place, torch
    ops on any device: ``record_bounce``'s body past its closest hit (the
    JAX package's ``diff/replay.py:92-110`` and, with ``length``,
    ``utils/metrics.py:29``'s ``bounce``), then ``d`` advanced."""
    d = state["d"]
    o, dr = state["o"], state["dr"]
    if "length" in state:
        state["length"].add_(state["alive"])
    alive = state["alive"] & (d <= cfg.max_depth)
    hit, p, new_dir, _, ok = shade_slots(scene, cfg, key, ray_ids, d, o, dr,
                                         prim, hit)
    if "tape" in state:
        row = d.clamp(max=cfg.max_depth + 1).reshape(1)
        state["tape"].index_copy_(0, row,
                                  torch.where(alive & hit, prim, -1)[None])
    alive = alive & hit & ok & (d < cfg.max_depth)
    state["alive"].copy_(alive)
    o.copy_(torch.where(alive[:, None], p, o))
    dr.copy_(torch.where(alive[:, None], new_dir, dr))
    d.add_(1)


def record_shade_plain(state, prim, hit, *, scene, key, ray_ids, cfg):
    """K12's plain version in pool mode, in place, torch ops on any device:
    ``record_pool_pass``' body from the closest hit to the tape's scatter
    (the lanes that write nothing to the flat tape's last entry), then the
    survivors' next states compacted, in order, into the front of the pool
    (the slots past them keep what they held) and the pass record."""
    R = ray_ids.shape[0]
    o, d, ids, col, depth, alive = (state[k] for k in RECORD_ROWS)
    hit, p, new_dir, _, ok = shade_slots(scene, cfg, key, ids, depth, o, d,
                                         prim, hit)
    write = alive & hit
    state["tape"].scatter_(0, torch.where(
        write, depth * R + col, (cfg.max_depth + 1) * R), prim)
    cont = write & ok & (depth < cfg.max_depth)

    # A stable partition, survivors first: slot s < n_alive takes the s-th
    # survivor's next state.
    n_alive = cont.sum()
    slot = torch.arange(cont.shape[0], dtype=torch.int64, device=o.device)
    dest = torch.where(cont, torch.cumsum(cont, 0) - 1,
                       n_alive + torch.cumsum(~cont, 0) - 1)
    src = torch.empty_like(dest).index_copy_(0, dest, slot)
    front = slot < n_alive
    nexts = (p, new_dir, ids, col, depth + 1, cont)
    for k, v in zip(RECORD_ROWS, nexts):
        keep = front[:, None] if v.dim() == 2 else front
        state[k].copy_(torch.where(keep, v[src], state[k]))
    state["record"].copy_(torch.stack([n_alive, state["cursor"]]))


def record_regenerate_plain(state, *, camera, key, ray_ids, cfg, **_):
    """K13's plain version, in place, torch ops on any device: the slots
    past the pass record's survivors take the stream's entries from the
    record's cursor on (their ids gathered from ``ray_ids``, clamped into
    it; alive while inside it), and the cursor advances."""
    R = ray_ids.shape[0]
    o, d, ids, col, depth, alive = (state[k] for k in RECORD_ROWS)
    n_alive, cursor = state["record"]
    slot = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    is_tail = slot >= n_alive
    fresh_idx = cursor + slot - n_alive
    idx = fresh_idx.clamp(0, max(R - 1, 0))
    f_ids = ray_ids[idx]
    fo, fd = camera_rays_plain(camera, cfg.nx, cfg.ny, cfg.spp, key, f_ids)
    tail = is_tail[:, None]
    o.copy_(torch.where(tail, fo, o))
    d.copy_(torch.where(tail, fd, d))
    ids.copy_(torch.where(is_tail, f_ids, ids))
    col.copy_(torch.where(is_tail, idx, col))
    depth.copy_(torch.where(is_tail, 0, depth))
    alive.copy_(torch.where(is_tail, fresh_idx < R, alive))
    state["cursor"].copy_(cursor + torch.minimum(
        o.shape[0] - n_alive, (R - cursor).clamp(min=0)))


def _launch_step(state, prim, hit, *, scene, key, ray_ids, cfg):
    """K12 in lockstep or length mode over the state's rays, in place, the
    counter advanced (``record_step``); one block for no rays."""
    from ..kernels import megakernel

    f32, i64 = torch.float32, torch.int64
    dev = state["alive"].device
    R = state["alive"].shape[0]
    names = [("o", f32, (R, 3)), ("dr", f32, (R, 3)),
             ("alive", torch.bool, (R,)), ("d", i64, ()),
             ("arrivals", i64, ())]
    if "tape" in state:
        names.append(("tape", torch.int32, (cfg.max_depth + 2, R)))
    if "length" in state:
        names.append(("length", i64, (R,)))
    for name, dtype, shape in names:
        _check(f"state[{name!r}]", state[name], dtype, shape, dev)
    _check("ray_ids", ray_ids, i64, (R,), dev)
    prim, hit = _hits(prim, hit, R, dev)
    k = rng.device_key(key, dev)
    tape, length = state.get("tape"), state.get("length")
    megakernel.launch_entry(
        dev, "frt_record_step", k.data_ptr(), *_scene_args(scene, dev),
        state["o"].data_ptr(), state["dr"].data_ptr(),
        state["alive"].data_ptr(), ray_ids.data_ptr(), state["d"].data_ptr(),
        state["arrivals"].data_ptr(), prim.data_ptr(), hit.data_ptr(),
        None if tape is None else tape.data_ptr(),
        None if length is None else length.data_ptr(), int(cfg.max_depth),
        float(cfg.t_min), R)
    if tape is not None:
        record_step.launches += 1
    else:
        record_step.length_launches += 1


def record_step(state, prim, hit, *, scene, key, ray_ids, cfg):
    """The lockstep recorder's bounce past its closest hit ``(prim, hit)``,
    in place, on ``record_state``'s state (with a ``tape``, or a ``length``
    for the occupancy scan), the bounce counter ``d`` advanced.  Launches
    K12 for a CUDA state (float32 rays, the scene on its device) and runs
    ``record_step_plain`` for a CPU one; bit-equal either way."""
    dev = state["alive"].device
    if dev.type == "cpu":
        return record_step_plain(state, prim, hit, scene=scene, key=key,
                                 ray_ids=ray_ids, cfg=cfg)
    if dev.type != "cuda":
        raise ValueError(f"no recorder kernel for device {dev}")
    return _launch_step(state, prim, hit, scene=scene, key=key,
                        ray_ids=ray_ids, cfg=cfg)


record_step.launches = 0  # K12 launches in lockstep mode (CUDA path only)
record_step.length_launches = 0  # ... in length mode


def _launch_shade(state, prim, hit, *, scene, camera, key, ray_ids, cfg):
    """K12 in pool mode over the pool's slots, K13's refill of the tail in
    the same launch, in place (``record_shade``)."""
    from ..kernels import megakernel

    f32, i64 = torch.float32, torch.int64
    dev = state["alive"].device
    C, R = state["alive"].shape[0], ray_ids.shape[0]
    if C >= 2 ** 31:
        raise ValueError(f"a pool of {C} slots: K12's scan counts in 32 bits")
    if R < 1:
        raise ValueError("K12's refill needs a stream of at least one ray id")
    for name, dtype, shape in (
            ("o", f32, (C, 3)), ("d", f32, (C, 3)), ("ids", i64, (C,)),
            ("col", i64, (C,)), ("depth", i64, (C,)),
            ("alive", torch.bool, (C,)),
            ("tape", torch.int32, ((cfg.max_depth + 1) * R + 1,)),
            ("cursor", i64, ()), ("record", i64, (2,)),
            ("scan", i64, (1 + -(-C // RECORD_TILE),))):
        _check(f"state[{name!r}]", state[name], dtype, shape, dev)
    _check("ray_ids", ray_ids, i64, (R,), dev)
    fields = [getattr(camera, f) for f in _FIELDS]
    for name, t in zip(_FIELDS, fields):
        if t.requires_grad:
            raise ValueError(f"camera.{name} requires grad: K12 has no "
                             "gradient")
        _check(f"camera.{name}", t, f32,
               () if name == "lens_radius" else (3,), dev)
    if min(cfg.nx, cfg.ny, cfg.spp) < 1:
        raise ValueError(f"bad image size {cfg.nx}x{cfg.ny}@{cfg.spp}")
    prim, hit = _hits(prim, hit, C, dev)
    k = rng.device_key(key, dev)
    megakernel.launch_entry(
        dev, "frt_record_pool", k.data_ptr(), *_scene_args(scene, dev),
        *(state[n].data_ptr() for n in RECORD_ROWS), prim.data_ptr(),
        hit.data_ptr(), state["tape"].data_ptr(), ray_ids.data_ptr(), R,
        int(cfg.max_depth), float(cfg.t_min), state["cursor"].data_ptr(),
        state["record"].data_ptr(), state["scan"].data_ptr(),
        *(t.data_ptr() for t in fields), int(cfg.nx), int(cfg.ny),
        int(cfg.spp), C)
    if C:
        record_shade.launches += 1
        record_shade.refill_launches += 1


def record_shade(state, prim, hit, *, scene, camera, key, ray_ids, cfg):
    """The pool recorder's pass past its closest hit ``(prim, hit)``, in
    place, on ``record_pool_state``'s state: the tape's entries, the
    survivors compacted, the pass record, the tail refilled from the
    stream and the cursor advanced.  Launches K12 in pool mode (K13 folded
    in) for a CUDA pool (a float32 camera on its device) and runs
    ``record_shade_plain`` then ``record_regenerate_plain`` for a CPU one;
    bit-equal either way (but for the flat tape's last entry, which nothing
    reads)."""
    dev = state["alive"].device
    if dev.type == "cpu":
        record_shade_plain(state, prim, hit, scene=scene, key=key,
                           ray_ids=ray_ids, cfg=cfg)
        return record_regenerate_plain(state, camera=camera, key=key,
                                       ray_ids=ray_ids, cfg=cfg)
    if dev.type != "cuda":
        raise ValueError(f"no recorder kernel for device {dev}")
    return _launch_shade(state, prim, hit, scene=scene, camera=camera,
                         key=key, ray_ids=ray_ids, cfg=cfg)


# K12 launches in pool mode (CUDA path only), and K13's, folded into them:
# the launches that refilled the tail.
record_shade.launches = 0
record_shade.refill_launches = 0
