"""Differentiable rendering: losses, gradients and inverse-rendering steps.

Port of ``first_raytracer_tpu.diff.grad``.  The counter RNG holds every
uniform fixed, so the rendered radiance is a piecewise smooth function of
the scene parameters and ``torch.autograd`` differentiates it: gradients
flow through the hit equation (recomputed from the primitive id), the
scatter directions and the Schlick, texture and throughput math.
Primitive selection and the reflect/refract coin are not differentiated.

Parameters are a dict of leaf tensors (``split_params``); a gradient
function returns ``(loss, grads)`` with ``grads`` a dict of the same keys.
Two equivalent radiance paths: ``method="replay"`` (default) records the
primitive tape outside autograd and differentiates the tape replay
(``diff/replay.py``); ``method="scan"`` differentiates the wavefront
integrator's fixed-trip loop directly, kept as the equivalence oracle: its
value and gradient (``scan_loss_and_grads``) replay one CUDA graph per
static signature on the card (``SCAN_GRAPHS``), as JAX jits it.

The direct step (``render_loss_and_grads``, ``sgd_step``,
``make_fit_step``) is the JAX package's jitted one: the recorder's loop
(``diff/replay.py``, through ``render.graphed.run_loop``: CUDA graphs on
the card, the bounce counter on the device) and then the value and
gradient of the replay over the whole tape, a replay of the CUDA graph of
``tape_loss_and_grads`` (``GRAPHS``).  Its ``graphed`` argument is the
recorder's route (``render.graphed.graphed_route``) and the body's:
``graphed=False`` runs both op by op.

The fit steps update the parameters in place through a ``torch.optim``
optimizer built over them (``make_optimizer``), where the JAX package
returns new parameters and an optax state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.megakernel import DENSE_MAX
from ..kernels.record_mega import MAX_RAY_ID
from ..render.camera import camera_rays
from ..render.integrator import RenderConfig, default_intersect, trace_rays
from .graphed import GraphCache
from .replay import (plan_buckets, record_camera_paths, record_paths_pool,
                     trace_rays_replay)

__all__ = ["DIFF_FIELDS", "split_params", "merge_params", "ray_radiance",
           "record_tape", "render_loss", "render_loss_and_grads",
           "render_loss_and_grads_tape", "render_loss_and_grads_bucketed",
           "render_loss_and_grads_scan", "tape_loss_and_grads",
           "bucketed_loss_and_grads", "scan_loss_and_grads", "GRAPHS",
           "SCAN_GRAPHS", "value_and_grad",
           "sgd_step", "make_optimizer", "apply_grads", "make_fit_step",
           "tape_recorder", "render_loss_and_grads_recorded",
           "make_fit_step_replay"]

# Material albedo / fuzz / IOR, sphere centers and radii, the checker's
# second color and triangle vertices.
DIFF_FIELDS = ("sphere_center", "sphere_radius", "albedo", "albedo2",
               "fuzz", "ref_idx", "tri_v0", "tri_v1", "tri_v2")


def split_params(scene, fields=DIFF_FIELDS):
    """Scene -> (params, scene); params maps each field to a new leaf
    tensor (a copy) with ``requires_grad``."""
    return ({f: getattr(scene, f).detach().clone().requires_grad_(True)
             for f in fields}, scene)


def merge_params(scene, params):
    return dataclasses.replace(scene, **params)


def _rays(camera, cfg, key, ray_ids):
    return camera_rays(camera, cfg.nx, cfg.ny, cfg.spp, key, ray_ids)


def record_tape(params, scene, camera, cfg: RenderConfig, key, ray_ids,
                accel=None, intersect_fn: Optional[Callable] = None,
                record_pool: int = 0, graphed: Optional[bool] = None):
    """The (max_depth + 1, R) tape of the scene under ``params`` (detached):
    the lockstep recorder of the camera rays, or the pool recorder with
    ``record_pool`` slots, through ``render.graphed.run_loop``."""
    s = merge_params(scene, {k: v.detach() for k, v in params.items()})
    if record_pool:
        return record_paths_pool(s, camera, cfg, key, ray_ids, accel,
                                 intersect_fn, pool_size=record_pool,
                                 graphed=graphed)
    return record_camera_paths(s, camera, cfg, key, ray_ids, accel,
                               intersect_fn, graphed=graphed)


def ray_radiance(params, scene, camera, cfg: RenderConfig, key, ray_ids,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 method: str = "replay", record_pool: int = 0,
                 graphed: Optional[bool] = None):
    """(R, 3) radiance as a differentiable function of ``params``.

    ``method="replay"``: record the primitive tape outside autograd
    (``record_tape``: the lockstep recorder, or the pool recorder with
    ``record_pool`` slots; ``graphed`` is its route), then replay it.
    ``method="scan"``: the wavefront integrator with
    ``differentiable=True``, eagerly (the result stays attached to
    autograd).  The closest hit is ``intersect_fn`` on ``accel``
    (``render.integrator.default_intersect`` by default); an accel built
    from other parameters than ``params`` is used as it is.
    """
    if method == "replay":
        tape = record_tape(params, scene, camera, cfg, key, ray_ids, accel,
                           intersect_fn, record_pool, graphed)
    elif method != "scan":
        raise ValueError(f"unknown method {method!r}")
    scene = merge_params(scene, params)
    o, d = _rays(camera, cfg, key, ray_ids)
    if method == "replay":
        return trace_rays_replay(scene, o, d, ray_ids, key, cfg, tape)
    return trace_rays(scene, o, d, ray_ids, key,
                      dataclasses.replace(cfg, differentiable=True),
                      accel=accel, intersect_fn=intersect_fn)


def _squared_error(rad, target, num_values=None):
    """The mean of ``(rad - target) ** 2``, or with ``num_values`` its sum
    over that count (a rank of a sharded step passes the whole batch's)."""
    if num_values is None:
        return torch.mean((rad - target) ** 2)
    return torch.sum((rad - target) ** 2) / num_values


def render_loss(params, scene, camera, cfg, key, ray_ids, target,
                accel=None, intersect_fn: Optional[Callable] = None,
                method: str = "replay", record_pool: int = 0,
                graphed: Optional[bool] = None):
    """Mean squared error between rendered per-ray radiance and ``target``."""
    rad = ray_radiance(params, scene, camera, cfg, key, ray_ids, accel,
                       intersect_fn, method=method, record_pool=record_pool,
                       graphed=graphed)
    return _squared_error(rad, target)


def value_and_grad(loss_fn, params):
    """(loss, grads) of ``loss_fn(leaves)`` at ``params``; a leaf the loss
    does not reach gets a zero gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def render_loss_and_grads(params, scene, camera, cfg, key, ray_ids, target,
                          accel=None, intersect_fn: Optional[Callable] = None,
                          method: str = "replay", record_pool: int = 0,
                          graphed: Optional[bool] = None):
    """(loss, grads) of ``render_loss``: the JAX package's jitted
    ``render_loss_and_grads``.

    ``method="replay"``: ``record_tape`` (its loop through
    ``render.graphed.run_loop``, ``graphed`` its route), then the value and
    gradient of the replay over the whole (max_depth + 1, R) tape,
    ``render_loss_and_grads_tape`` (on a CUDA device a replay of its CUDA
    graph unless ``graphed=False``), as JAX replays every row.
    ``method="scan"``: ``render_loss_and_grads_scan`` (on a CUDA device a
    replay of its CUDA graph unless ``graphed=False``)."""
    if method == "replay":
        tape = record_tape(params, scene, camera, cfg, key, ray_ids, accel,
                           intersect_fn, record_pool, graphed)
        return render_loss_and_grads_tape(params, scene, camera, cfg, key,
                                          ray_ids, target, tape,
                                          graphed=graphed)
    if method != "scan":
        raise ValueError(f"unknown method {method!r}")
    return render_loss_and_grads_scan(params, scene, camera, cfg, key,
                                      ray_ids, target, accel, intersect_fn,
                                      graphed=graphed)


def tape_loss_and_grads(params, scene, camera, key, ray_ids, target, tape,
                        *, cfg, num_values=None):
    """The eager body of ``render_loss_and_grads_tape``: a plain function
    that the CPU runs and a CUDA device captures.  The loss is the mean,
    or with ``num_values`` the sum of squares over that count."""
    o, d = _rays(camera, cfg, key, ray_ids)

    def loss(p):
        rad = trace_rays_replay(merge_params(scene, p), o, d, ray_ids, key,
                                cfg, tape)
        return _squared_error(rad, target, num_values)

    return value_and_grad(loss, params)


def scan_loss_and_grads(params, scene, camera, key, ray_ids, target, accel,
                        *, cfg, intersect_fn, num_values=None):
    """The eager body of ``render_loss_and_grads_scan``: the camera rays
    (K8), the differentiable wavefront (``trace_rays`` with
    ``differentiable=True``: ``max_depth + 1`` trips unrolled, each a
    closest hit by ``intersect_fn`` on ``accel`` given the rays' liveness,
    its rows gathered from the scene's row tables (K16; their gradient
    K17), a draw (K7) and the shading in torch ops), the loss (the mean,
    or the sum of squares over ``num_values``) and
    ``torch.autograd.grad``.  A plain function that the CPU runs and a
    CUDA device captures."""
    o, d = _rays(camera, cfg, key, ray_ids)
    cfg = dataclasses.replace(cfg, differentiable=True)

    def loss(p):
        rad = trace_rays(merge_params(scene, p), o, d, ray_ids, key, cfg,
                         accel=accel, intersect_fn=intersect_fn)
        return _squared_error(rad, target, num_values)

    return value_and_grad(loss, params)


def bucketed_loss_and_grads(params, scene, camera, key, ray_ids, target,
                            tape, order, *, cfg, groups, num_values):
    """The eager body of ``render_loss_and_grads_bucketed``: the sort by
    ``order``, the rays of each group, the replay of its ``trips`` rows,
    the sum of squares over ``num_values`` and ``torch.autograd.grad``.
    A plain function that the CPU runs and a CUDA device captures."""
    ids_s = ray_ids[order]
    target_s = target[order]
    tape_s = tape.index_select(1, order)

    def loss(p):
        s = merge_params(scene, p)
        total = torch.zeros((), dtype=torch.float32, device=target.device)
        for g0, n, trips in groups:
            ids_g = ids_s[g0:g0 + n]
            o, d = _rays(camera, cfg, key, ids_g)
            rad = trace_rays_replay(s, o, d, ids_g, key, cfg,
                                    tape_s[:trips, g0:g0 + n])
            total = total + torch.sum((rad - target_s[g0:g0 + n]) ** 2)
        return total / num_values

    return value_and_grad(loss, params)


# The CUDA graphs of the replay's bodies above, by static signature: the
# counterpart of the JAX package's jit cache, which retraces once per
# bucket-shape combination; a plan that changes every step captures every
# step.  On the CPU the bodies run eagerly on its static buffers.
GRAPHS = GraphCache(maxsize=4)
# The scan's graphs, kept apart: a capture holds every trip's saved tensors
# in its pool (at 2^17 rays of the final scene a few GB, PERF.md section
# 5), so only the most recent signature is kept.
SCAN_GRAPHS = GraphCache(maxsize=1)


def render_loss_and_grads_tape(params, scene, camera, cfg, key, ray_ids,
                               target, tape,
                               num_values: Optional[int] = None,
                               graphed: Optional[bool] = None):
    """(loss, grads) for a recorded (possibly ``live_trips``-trimmed)
    primitive tape: only the replay is differentiated.  The body
    (``tape_loss_and_grads``) goes through ``GRAPHS``, on a CUDA device a
    replay of its CUDA graph, unless ``graphed=False``, which runs it op by
    op.  With ``num_values`` (static) the loss is the sum of squares over
    that count."""
    static = dict(cfg=cfg, num_values=num_values)
    inputs = dict(params=params, scene=scene, camera=camera, key=key,
                  ray_ids=ray_ids, target=target, tape=tape)
    if graphed is False:
        return tape_loss_and_grads(**inputs, **static)
    return GRAPHS.run(tape_loss_and_grads, static, inputs, target.device)


def render_loss_and_grads_scan(params, scene, camera, cfg, key, ray_ids,
                               target, accel=None,
                               intersect_fn: Optional[Callable] = None,
                               graphed: Optional[bool] = None,
                               num_values: Optional[int] = None):
    """(loss, grads) of the differentiable scan (``method="scan"``): the
    JAX package's jitted ``render_loss_and_grads`` with ``method`` static.
    The body (``scan_loss_and_grads``) goes through ``SCAN_GRAPHS``, which
    on a CUDA device captures it once per static signature (``cfg``,
    ``intersect_fn``, ``num_values``, the shapes) and replays it on this
    call's parameters, scene, camera, key, ray ids, target and accel.
    ``graphed`` is the route of ``render.graphed.graphed_route``: a Python
    ``intersect_fn`` of the caller's needs it, and ``graphed=False`` runs
    the body op by op."""
    from ..render.graphed import graphed_route
    if intersect_fn is None:
        intersect_fn = default_intersect
    static = dict(cfg=cfg, intersect_fn=intersect_fn, num_values=num_values)
    inputs = dict(params=params, scene=scene, camera=camera, key=key,
                  ray_ids=ray_ids, target=target, accel=accel)
    if graphed_route(target.device, accel, intersect_fn, graphed):
        return SCAN_GRAPHS.run(scan_loss_and_grads, static, inputs,
                               target.device)
    return scan_loss_and_grads(**inputs, **static)


def render_loss_and_grads_bucketed(params, scene, camera, cfg, key,
                                   ray_ids, target, tape, plan=None,
                                   max_groups: int = 4,
                                   num_values: Optional[int] = None):
    """(loss, grads) replaying depth-sorted ray buckets (``plan_buckets``):
    each bucket replays only its own trip count, so the replay's work is
    about R x the mean path length instead of R x the deepest.  Equal to
    ``render_loss_and_grads_tape`` on the whole tape up to f32 summation
    order.

    ``plan`` (from ``plan_buckets(tape, max_groups)``) may be passed so
    that repeated calls on one tape skip the host-side sort.  The default
    of 4 groups here against 6 in ``plan_buckets`` is the JAX package's,
    kept on purpose so that both packages plan the same buckets.  The sum
    of squares is divided by ``num_values``, by default the target's
    element count: a rank of a sharded step passes the whole batch's
    (``parallel/shard.py``).

    On a CUDA device the body (``bucketed_loss_and_grads``) runs as a
    CUDA graph captured once per static signature (the plan's groups, the
    shapes of the tape and the scene, ``cfg``, ``num_values``, the params'
    names, shapes and dtypes) and replayed on this call's parameters,
    scene, camera, key, ray ids, target, tape and order
    (``diff/graphed.py``).
    """
    if num_values is None:
        num_values = target.shape[0] * target.shape[1]
    if plan is None:
        plan = plan_buckets(tape, max_groups)
    order, groups = plan
    return GRAPHS.run(
        bucketed_loss_and_grads,
        dict(cfg=cfg, groups=groups, num_values=num_values),
        dict(params=params, scene=scene, camera=camera, key=key,
             ray_ids=ray_ids, target=target, tape=tape, order=order),
        target.device)


def sgd_step(params, scene, camera, cfg, key, ray_ids, target,
             lr: float = 0.05, accel=None,
             intersect_fn: Optional[Callable] = None,
             graphed: Optional[bool] = None):
    """One inverse-rendering SGD step; returns (loss, new_params)."""
    loss, grads = render_loss_and_grads(params, scene, camera, cfg, key,
                                        ray_ids, target, accel, intersect_fn,
                                        graphed=graphed)
    return loss, {k: (p - lr * grads[k]).detach() for k, p in params.items()}


# optax's optimizers by the name the CLI takes, with optax's defaults where
# torch's differ (adamw's weight decay 1e-4, rmsprop's decay 0.9).
_OPTIMIZERS = {
    "sgd": lambda ps, lr: torch.optim.SGD(ps, lr=lr),
    "adam": lambda ps, lr: torch.optim.Adam(ps, lr=lr),
    "adamw": lambda ps, lr: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4),
    "rmsprop": lambda ps, lr: torch.optim.RMSprop(ps, lr=lr, alpha=0.9),
}


def make_optimizer(name: str, params, lr: float):
    """A ``torch.optim`` optimizer over the tensors of the ``params`` dict:
    ``sgd``, ``adam``, ``adamw`` or ``rmsprop``."""
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; one of "
                         f"{sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](list(params.values()), lr)


def apply_grads(optimizer, params, grads):
    """Sets each parameter's ``.grad`` and takes one optimizer step."""
    for k, p in params.items():
        p.grad = grads[k]
    optimizer.step()


def make_fit_step(scene, camera, cfg, ray_ids, target, optimizer,
                  accel=None, intersect_fn: Optional[Callable] = None,
                  device="cuda", graphed: Optional[bool] = None):
    """Inverse-rendering step around a ``torch.optim`` optimizer.

    Returns ``step(params, key) -> loss``: the gradient of the MSE loss
    (``render_loss_and_grads``, closest hit by ``intersect_fn`` on
    ``accel``, ``graphed`` the route of the recorder and of the tape's
    value and gradient) followed by
    ``optimizer.step()`` outside the graphs, which updates ``params`` in
    place; the optimizer must have been built over ``params``' tensors,
    which live on ``device``.  The scene, camera, accel, ray ids and target
    are moved to ``device``.
    """
    dev = torch.device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    ray_ids, target = ray_ids.to(dev), target.to(dev)
    if accel is not None:
        accel = accel.to(dev)

    def step(params, key):
        loss, grads = render_loss_and_grads(params, scene, camera, cfg, key,
                                            ray_ids, target, accel,
                                            intersect_fn, graphed=graphed)
        apply_grads(optimizer, params, grads)
        return loss

    return step


def tape_recorder(scene, camera, cfg, ray_ids, device="cuda"):
    """The recorder of ``make_fit_step_replay`` for ``ray_ids``:
    ``record(scene, key) -> tape`` (D, R) for the scene as it then stands
    (the same primitives; moved or recoloured).  It follows the scene and
    the ray ids:

    - contiguous ids below 2^24 and at most 1024 spheres and 1024
      triangles: K2b, ``record_paths_mega`` on the dense pack;
    - contiguous ids and a larger scene (below 2^24 primitives): K3t,
      ``record_paths_mega_clustered`` on the clustered pack.  Its
      ``ClusterLayout`` is frozen here, so every call keeps the cluster
      memberships while boxes and payload follow the scene;
    - ids that are not contiguous or reach past 2^24: the wavefront
      ``record_camera_paths`` (its loop a CUDA graph on the card).

    Each recorder is the CUDA kernel on a GPU and its plain version on the
    CPU.
    """
    from ..kernels.megakernel_clustered import pack_scene_mega_clustered
    from ..kernels.record_mega import (pack_scene_mega, record_paths_mega,
                                       record_paths_mega_clustered)

    dev = torch.device(device)
    ids_np = ray_ids.cpu().numpy()
    n = len(ids_np)
    contiguous = bool((np.diff(ids_np) == 1).all()) if n else True
    ray0 = int(ids_np[0]) if n else 0
    in_range = contiguous and ray0 + n <= MAX_RAY_ID
    if in_range and max(scene.num_spheres, scene.num_triangles) <= DENSE_MAX:
        def record(s, key):
            return record_paths_mega(pack_scene_mega(s, dev), camera, cfg,
                                     key, ray0=ray0, num_rays=n)
    elif in_range and scene.num_primitives < MAX_RAY_ID:
        _, layout = pack_scene_mega_clustered(scene, camera,
                                              return_layout=True, device=dev)

        def record(s, key):
            pack = pack_scene_mega_clustered(s, camera, layout=layout,
                                             device=dev)
            return record_paths_mega_clustered(pack, camera, cfg, key,
                                               ray0=ray0, num_rays=n)
    else:
        def record(s, key):
            return record_camera_paths(s, camera, cfg, key, ray_ids)
    return record


def render_loss_and_grads_recorded(params, scene, camera, cfg, key,
                                   ray_ids, target, record,
                                   max_groups: int = 4, mesh=None):
    """The record->replay gradient of the scene under ``params``:
    ``record`` (from ``tape_recorder``) records the primitive tape and
    ``render_loss_and_grads_bucketed`` differentiates its bucketed replay.
    Returns ``(loss, grads, tape)``.

    With a ``mesh`` (``parallel.mesh.RenderMesh``) the rays are split over
    its ranks: ``ray_ids`` and ``target`` are the whole batch, ``record``
    records this rank's block of them (``mesh.ray_block``), the block's sum
    of squares is divided by the whole batch's value count, and the loss
    and every gradient are summed over the ranks (``mesh.sum_over_ranks``);
    the tape is this rank's.
    """
    num_values = target.shape[0] * target.shape[1]
    if mesh is not None:
        lo, hi = mesh.ray_block(ray_ids.shape[0])
        ray_ids, target = ray_ids[lo:hi], target[lo:hi]
    s = merge_params(scene, {k: v.detach() for k, v in params.items()})
    tape = record(s, key)
    loss, grads = render_loss_and_grads_bucketed(
        params, scene, camera, cfg, key, ray_ids, target, tape,
        max_groups=max_groups, num_values=num_values)
    if mesh is not None:
        loss, grads = mesh.sum_over_ranks(loss, grads)
    return loss, grads, tape


def make_fit_step_replay(scene, camera, cfg, ray_ids, target, optimizer,
                         max_groups: int = 4, device="cuda", mesh=None):
    """Inverse-rendering step on the record->replay path.

    Per step: repack the current scene for the recorder, record the
    primitive tape (``tape_recorder``: K2b, K3t or the wavefront recorder
    by the scene's size and the ids), plan depth buckets and differentiate
    only the bucketed replay (``render_loss_and_grads_recorded``), then
    ``optimizer.step()``.  Returns ``step(params, key) -> loss``; as in
    ``make_fit_step``, ``params`` are updated in place and live on
    ``device`` (a bare ``"cuda"`` is this process's GPU,
    ``parallel.mesh.local_device``).

    With a ``mesh`` the rays are split over its ranks: each step records
    and replays this rank's block and sums the loss and gradients over the
    ranks before the optimizer's step, so that every rank keeps identical
    parameters.
    """
    from ..parallel.mesh import local_device

    dev = local_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    ray_ids, target = ray_ids.to(dev), target.to(dev)
    lo, hi = (0, ray_ids.shape[0]) if mesh is None else mesh.ray_block(
        ray_ids.shape[0])
    record = tape_recorder(scene, camera, cfg, ray_ids[lo:hi], dev)

    def step(params, key):
        loss, grads, _ = render_loss_and_grads_recorded(
            params, scene, camera, cfg, key, ray_ids, target, record,
            max_groups=max_groups, mesh=mesh)
        apply_grads(optimizer, params, grads)
        return loss

    return step
