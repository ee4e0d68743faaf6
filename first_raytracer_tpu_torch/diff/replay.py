"""Path-replay differentiable rendering: record once, differentiate a replay.

Port of ``first_raytracer_tpu.diff.replay``.  Primitive *selection* is not
differentiated (the reparameterized-gradient contract: differentiate the hit
equation, not the traversal), so the pass splits in two:

1. **Record** (outside autograd): trace the paths and keep only the winning
   primitive id per (bounce, ray), a ``(max_depth + 1, R)`` int32 tape, -1
   for a miss or a dead path.  ``record_paths`` is the lockstep wavefront
   recorder, ``record_paths_pool`` a compacted regenerating pool with the
   same tape, both with the integrator's pluggable closest hit
   (``intersect_fn`` on ``accel``) and, past it, ``diff/record_pass.py``
   (K12, with K13 folded in, on the card); ``kernels/record_mega.py`` records it on the
   GPU in one kernel.  Both recorders are the JAX package's
   ``while_loop``s: a state of fixed shape (``record_state``,
   ``record_pool_state``) advanced in place by a body that reads nothing
   back (``record_bounce``, ``record_pool_pass``), the bounce counter, the
   survivor count and the stream's cursor on the device, run through
   ``render.graphed.run_loop`` (CUDA graphs on the card, one read of
   "any ray alive" per block of passes).
2. **Replay** (differentiated by ``torch.autograd``): a Python loop over the
   tape's rows in which each bounce recomputes the hit record from the
   recorded id and shades.  No intersection appears in the autograd graph.

The winner's geometry and material come from per-primitive payload tables
by an exact ``index_select``, whose backward is an ``index_add``.  The JAX
package extracts them with a one-hot matmul on the TPU's matrix unit and
switches to a gather above 4096 primitives; on a GPU the gather is exact
and cheap at every size, so there is one path.  No checkpointing: at 2^17
rays and 51 trips the saved activations are about 1.6 GB.

``live_trips`` and ``plan_buckets`` are host NumPy, copied: they trim the
all-dead rows of a tape and sort rays into depth buckets so that each
bucket replays only its own trip count.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from ..core.vecmath import constant, point_at
from ..geometry.sphere import BIG, sphere_hit_one, sphere_normal
from ..geometry.triangle import triangle_hit_one, triangle_normal
from ..materials.scatter import scatter_from_params
from ..render.camera import camera_rays
from ..render.integrator import (UP, RenderConfig, closest_hit,
                                 default_intersect, sky_color)
from ..scene.textures import texture_from_params
from .record_pass import record_scratch, record_shade, record_step

__all__ = ["record_paths", "record_camera_paths", "record_paths_pool",
           "record_state", "camera_record_state", "record_bounce",
           "record_pool_state", "record_pool_pass", "trace_rays_replay",
           "live_trips", "plan_buckets"]


def record_state(origin, direction, *, cfg, tape=True, **_):
    """The lockstep recorder's state before its first bounce: the rays
    ``o`` and ``dr`` (copies), ``alive``, the bounce counter ``d`` (a 0-d
    int64 tensor on the rays' device), K12's arrival word ``arrivals`` (0-d
    int64, zero between bounces: the blocks of a launch arrive on it and
    the last one advances ``d``) and, with ``tape``, the int32 tape of -1s
    with one scratch row past the ``max_depth + 1`` it returns, which the
    inert passes past the last bounce write."""
    R, dev = origin.shape[0], origin.device
    state = dict(o=origin.clone(), dr=direction.clone(),
                 alive=torch.ones((R,), dtype=torch.bool, device=dev),
                 d=torch.zeros((), dtype=torch.int64, device=dev),
                 arrivals=torch.zeros((), dtype=torch.int64, device=dev))
    if tape:
        state["tape"] = torch.full((cfg.max_depth + 2, R), -1,
                                   dtype=torch.int32, device=dev)
    return state


def camera_record_state(camera, key, ray_ids, *, cfg, tape=True, **_):
    """``record_state`` of the camera rays of ``ray_ids`` (RNG domain 0),
    made inside the state's own init."""
    o, d = camera_rays(camera, cfg.nx, cfg.ny, cfg.spp, key, ray_ids)
    return record_state(o, d, cfg=cfg, tape=tape)


@torch.no_grad()
def record_bounce(state, *, scene, accel, key, ray_ids, cfg, intersect_fn,
                  **_):
    """One bounce of the lockstep recorder, in place: the body of the JAX
    package's ``while_loop`` (``diff/replay.py:71-115`` there), with its
    test ``(d <= max_depth) & any(alive)`` folded into ``alive``.  The
    closest hit, then ``diff.record_pass.record_step`` (K12 on a CUDA
    device, ``record_step_plain`` on the CPU), which also advances the
    counter.  No host read and no tensor from host data; a pass after the
    last bounce changes nothing but the scratch row and the counter."""
    prim, _, hit = closest_hit(intersect_fn, scene, accel, state["o"],
                               state["dr"], cfg.t_min, state["alive"])
    record_step(state, prim, hit, scene=scene, key=key, ray_ids=ray_ids,
                cfg=cfg)


def _lockstep(init, inputs, cfg, intersect_fn, graphed):
    from ..render.graphed import run_loop
    static = dict(cfg=cfg, intersect_fn=intersect_fn or default_intersect)
    tape = run_loop(init, record_bounce, static, inputs,
                    inputs["ray_ids"].device, ("tape",), graphed)["tape"]
    return tape[:cfg.max_depth + 1]


@torch.no_grad()
def record_paths(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 graphed: Optional[bool] = None):
    """Trace R rays forward and return the (max_depth + 1, R) int32 tape.

    Entry ``tape[d, i]`` is the global primitive id ray ``i`` hit at bounce
    ``d`` (after the recompute-authority check), or -1 when the ray missed,
    was already dead, or an earlier scatter absorbed it.  Every ray sweeps
    every bounce until all are dead (the JAX package's lockstep
    ``while_loop``).  ``intersect_fn`` on ``accel`` finds the closest hit
    (``render.integrator.default_intersect`` by default).  Runs without
    autograd, ``record_state`` then blocks of ``record_bounce`` through
    ``render.graphed.run_loop``: on a CUDA device CUDA graphs unless
    ``graphed=False`` (``render.graphed.graphed_route``).
    """
    return _lockstep(record_state, dict(
        scene=scene, accel=accel, key=key, origin=origin,
        direction=direction, ray_ids=ray_ids), cfg, intersect_fn, graphed)


@torch.no_grad()
def record_camera_paths(scene, camera, cfg: RenderConfig, key, ray_ids,
                        accel=None, intersect_fn: Optional[Callable] = None,
                        graphed: Optional[bool] = None):
    """``record_paths`` of the camera rays of ``ray_ids``, which the
    loop's init makes (``camera_record_state``): the same tape."""
    return _lockstep(camera_record_state, dict(
        scene=scene, accel=accel, key=key, camera=camera, ray_ids=ray_ids),
        cfg, intersect_fn, graphed)


def _stream_rays(camera, cfg, key, ray_ids, idx):
    """(ids, origin, direction) of the stream's entries ``idx`` (clamped
    into the stream)."""
    ids = ray_ids[idx.clamp(0, max(ray_ids.shape[0] - 1, 0))]
    o, d = camera_rays(camera, cfg.nx, cfg.ny, cfg.spp, key, ids)
    return ids, o, d


def record_pool_state(camera, key, ray_ids, *, cfg, pool_size, **_):
    """The pool recorder's state before its first pass: slot s holds the
    stream's entry s (alive while s < R), its tape column ``col``, the
    stream's ``cursor`` (0-d int64), the flat tape of -1s, (D * R + 1,)
    with D = max_depth + 1 (its last entry takes the plain pass's lanes
    that write nothing), and the pass record and K12's scan words
    (``diff.record_pass.record_scratch``)."""
    C, R, dev = pool_size, ray_ids.shape[0], ray_ids.device
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    col = slot.clamp(max=max(R - 1, 0))
    ids, o, d = _stream_rays(camera, cfg, key, ray_ids, col)
    n0 = min(C, R)
    return dict(o=o, d=d, ids=ids, col=col,
                depth=torch.zeros((C,), dtype=torch.int64, device=dev),
                alive=slot < n0,
                cursor=torch.full((), n0, dtype=torch.int64, device=dev),
                tape=torch.full(((cfg.max_depth + 1) * R + 1,), -1,
                                dtype=torch.int32, device=dev),
                **record_scratch(C, dev))


@torch.no_grad()
def record_pool_pass(state, *, scene, camera, accel, key, ray_ids, cfg,
                     intersect_fn, **_):
    """One pass of the pool recorder, in place (the JAX package's loop
    body, ``diff/replay.py:167-206`` there): no host read, every shape
    fixed.  The closest hit, then ``diff.record_pass.record_shade``: the
    hits to the flat tape, the survivors moved in order to the front, and
    every slot past them given the stream's next ray (one launch of K12,
    K13 folded in, on a CUDA device).  Once every slot is dead and the
    stream is spent it changes nothing the tape returns."""
    prim, _, hit = closest_hit(intersect_fn, scene, accel, state["o"],
                               state["d"], cfg.t_min, state["alive"])
    record_shade(state, prim, hit, scene=scene, camera=camera, key=key,
                 ray_ids=ray_ids, cfg=cfg)


@torch.no_grad()
def record_paths_pool(scene, camera, cfg: RenderConfig, key, ray_ids,
                      accel=None, intersect_fn: Optional[Callable] = None,
                      pool_size: int = 8192,
                      graphed: Optional[bool] = None):
    """``record_paths`` through a compacted regenerating pool (same tape).

    A pool of ``pool_size`` ray slots stays near full: after each bounce
    the surviving rays are compacted to the front and the free slots are
    refilled from the ``ray_ids`` stream, so the recording cost follows the
    total segment count instead of R times the longest path.  Generates its
    own camera rays (RNG domain 0 per ray id).  ``accel`` and
    ``intersect_fn`` as for ``record_paths``.  Runs without autograd,
    ``record_pool_state`` then blocks of ``record_pool_pass`` through
    ``render.graphed.run_loop`` (CUDA graphs on the card unless
    ``graphed=False``).
    """
    from ..render.graphed import run_loop
    R, D = ray_ids.shape[0], cfg.max_depth + 1
    static = dict(cfg=cfg, pool_size=pool_size,
                  intersect_fn=intersect_fn or default_intersect)
    tape = run_loop(record_pool_state, record_pool_pass, static, dict(
        scene=scene, camera=camera, accel=accel, key=key, ray_ids=ray_ids),
        ray_ids.device, ("tape",), graphed)["tape"]
    return tape[:D * R].reshape(D, R)


def live_trips(tape) -> int:
    """Host-side: the number of replay trips the tape actually needs.

    The last row with any recorded hit, plus one trip for the misses of the
    rays scattered there (a miss at depth d implies a hit at d - 1, so no
    contribution lies deeper).  Replaying ``tape[:live_trips(tape)]`` is
    exact; the other rows are all -1.
    """
    rows = (tape >= 0).any(dim=1).cpu().numpy()
    if not rows.any():
        return 1
    return min(int(np.nonzero(rows)[0].max()) + 2, tape.shape[0])


def plan_buckets(tape, max_groups: int = 6, quantum: int = 1024):
    """Host-side replay plan: rays sorted by recorded path length, split
    into depth-ladder buckets.

    A lockstep replay runs every ray for the deepest ray's trip count; on
    the final scene one 50-bounce glass path makes every ray replay 51
    trips while the mean path is ~2.6.  Sorting rays by tape depth and
    replaying each bucket only to its own (power-of-two-rounded) trip count
    cuts the work to about R x the mean length, with identical per-ray
    radiance.  Buckets follow the depth ladder (one per power-of-two trip
    level); ``max_groups`` is enforced by greedily merging the adjacent
    pair whose merge adds the least replay work (merging upward only adds
    rows the tape marks dead).  Boundaries are floor-quantized to
    ``quantum`` rays, which only promotes rays into deeper buckets.

    Returns ``(order, groups)``: ``order`` is the (R,) int64 permutation on
    the tape's device, ``groups`` a tuple of ``(start, size, trips)``
    covering it.
    """
    t = tape.cpu().numpy()
    D, R = t.shape
    if R == 0:
        return (torch.zeros((0,), dtype=torch.int64, device=tape.device),
                ((0, 0, 1),))
    hit_any = t >= 0
    # Trips ray i needs: one past its deepest hit (the miss that follows),
    # capped at D; no-hit rays need exactly 1 (the sky trip).
    deepest = np.where(hit_any.any(axis=0),
                       (D - 1) - np.argmax(hit_any[::-1], axis=0), -1)
    need = np.minimum(deepest + 2, D).astype(np.int64)
    need = np.maximum(need, 1)
    order = np.argsort(need, kind="stable")
    sorted_need = need[order]
    # Tiny tapes (tests, small fits) still deserve several buckets.
    quantum = max(1, min(quantum, R // 16))

    def pow2_trips(n):
        return min(1 << max(int(n) - 1, 0).bit_length(), D)

    levels = sorted({pow2_trips(n) for n in
                     np.unique(sorted_need).tolist()})
    groups = []
    start = 0
    for lv in levels:
        end = int(np.searchsorted(sorted_need, lv, side="right"))
        if lv != levels[-1]:
            end = max((end // quantum) * quantum, start)
        if end > start:
            groups.append([start, end - start, lv])
            start = end
    if start < R:  # quantization left a tail for the deepest level
        if groups and groups[-1][2] == levels[-1]:
            groups[-1][1] += R - start
        else:
            groups.append([start, R - start, levels[-1]])
    # Enforce max_groups: merge the adjacent pair whose merge costs the
    # least extra replay work (size_lo x (trips_hi - trips_lo)).
    while len(groups) > max_groups:
        pen = [groups[i][1] * (groups[i + 1][2] - groups[i][2])
               for i in range(len(groups) - 1)]
        i = int(np.argmin(pen))
        groups[i + 1] = [groups[i][0], groups[i][1] + groups[i + 1][1],
                         groups[i + 1][2]]
        del groups[i]
    return (torch.from_numpy(order).to(tape.device),
            tuple(tuple(g) for g in groups))


def _mat_block(scene, mat_ids):
    """(N, 11) f32 material payload rows for per-primitive material ids:
    mtype, fuzz, ref_idx, albedo (3), albedo2 (3), tex_scale, tex_type.
    The integer types ride as f32 (exact) and are cast back on use."""
    m = mat_ids.long()
    return torch.cat([
        scene.mat_type[m].to(torch.float32)[:, None],
        scene.fuzz[m][:, None],
        scene.ref_idx[m][:, None],
        scene.albedo[m],
        scene.albedo2[m],
        scene.tex_scale[m][:, None],
        scene.tex_type[m].to(torch.float32)[:, None],
    ], dim=1)


def _payload_tables(scene):
    """Per-primitive payload tables: (Ns, 4 + 11) spheres, (Nt, 9 + 11)
    triangles; geometry and the material row in one table, differentiable
    in every scene leaf."""
    sph = tri = None
    if scene.num_spheres:
        sph = torch.cat([scene.sphere_center, scene.sphere_radius[:, None],
                         _mat_block(scene, scene.sphere_mat)], dim=1)
    if scene.num_triangles:
        tri = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2,
                         _mat_block(scene, scene.tri_mat)], dim=1)
    return sph, tri


class _Extract(torch.autograd.Function):
    """Payload rows ``table[idx]``: an exact gather forward, an
    ``index_add`` into a float64 buffer backward.

    The backward sums each row's gradient over the rays that read it in
    float64 and rounds it once: a row that many rays read (the ground
    sphere's, a hundred thousand at 2^17 rays) otherwise accumulates
    float32 rounding in proportion to their count, 3e-4 of the final
    scene's largest albedo gradient at 2^17 rays, so that the same rays
    summed in another grouping (the sharded step's ranks) gave another
    gradient.  The forward gathers in the table's own type."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        acc = grad.new_zeros((ctx.rows, grad.shape[1]), dtype=torch.float64)
        return acc.index_add_(0, idx, grad.double()).to(grad.dtype), None


_extract = _Extract.apply


def _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec, t_min):
    """Differentiable hit record and material payload from recorded ids.

    Mirrors ``render.integrator.recompute_hit`` branch for branch (clamped
    ids, masked mixed select).  Returns ``(t, p, n, mat_payload)``, the
    payload being the (R, 11) material block.
    """
    ns, nt = scene.num_spheres, scene.num_triangles
    rec0 = rec.long().clamp(min=0)
    if nt == 0:
        pay = _extract(sph_t, rec0.clamp(max=ns - 1))
        c, r = pay[:, 0:3], pay[:, 3]
        t = sphere_hit_one(o, dr, c, r, t_min, BIG)
        p, n = sphere_normal(o, dr, t, c, r)
        return t, p, n, pay[:, 4:]
    if ns == 0:
        pay = _extract(tri_t, rec0.clamp(max=nt - 1))
        v0, v1, v2 = pay[:, 0:3], pay[:, 3:6], pay[:, 6:9]
        t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
        return t, point_at(o, dr, t), triangle_normal(v0, v1, v2), pay[:, 9:]
    is_sph = rec0 < ns
    pay_s = _extract(sph_t, rec0.clamp(0, ns - 1))
    pay_t = _extract(tri_t, (rec0 - ns).clamp(0, nt - 1))
    c, r = pay_s[:, 0:3], pay_s[:, 3]
    v0, v1, v2 = pay_t[:, 0:3], pay_t[:, 3:6], pay_t[:, 6:9]
    t_s = sphere_hit_one(o, dr, c, r, t_min, BIG)
    t_t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
    t = torch.where(is_sph, t_s, t_t)
    p = point_at(o, dr, t)
    _, n_s = sphere_normal(o, dr, t, c, r)
    n = torch.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    mat = torch.where(is_sph[:, None], pay_s[:, 4:], pay_t[:, 9:])
    return t, p, n, mat


def trace_rays_replay(scene, origin, direction, ray_ids, key,
                      cfg: RenderConfig, tape):
    """Differentiable (R, 3) radiance from a recorded primitive tape.

    The masked math of ``trace_rays`` with the intersector replaced by a
    tape lookup; one trip per tape row (slice the tape with ``live_trips``
    to skip all-dead rows).  Dead and missing lanes get sanitized hit data
    before shading, so their t = BIG points feed no Inf or NaN into the
    gradients.
    """
    dev = origin.device
    R = origin.shape[0]
    sph_t, tri_t = _payload_tables(scene)
    up = constant(UP, torch.float32, dev)
    o, dr = origin, direction
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    for d in range(tape.shape[0]):
        rec = tape[d]
        t, p, n, matp = _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec,
                                           cfg.t_min)
        hit = (rec >= 0) & (t < BIG)
        p = torch.where(hit[:, None], p, 0.0)
        n = torch.where(hit[:, None], n, up)

        miss_now = alive & ~hit
        radiance = radiance + torch.where(
            miss_now[:, None], throughput * sky_color(dr), 0.0)

        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        tex = texture_from_params(matp[:, 10].to(torch.int32), matp[:, 3:6],
                                  matp[:, 6:9], matp[:, 9], p)
        new_dir, attenuation, scattered_ok = scatter_from_params(
            matp[:, 0].to(torch.int32), matp[:, 1], matp[:, 2], tex, dr, p,
            n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)

        throughput = torch.where(cont[:, None], throughput * attenuation,
                                 throughput)
        o = torch.where(cont[:, None], p, o)
        dr = torch.where(cont[:, None], new_dir, dr)
        alive = cont
    return radiance
