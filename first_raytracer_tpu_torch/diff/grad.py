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
integrator's fixed-trip loop directly, kept as the equivalence oracle.

The fit steps update the parameters in place through a ``torch.optim``
optimizer built over them (``make_optimizer``), where the JAX package
returns new parameters and an optax state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from ..kernels.megakernel import DENSE_MAX
from ..kernels.record_mega import MAX_RAY_ID
from ..render.camera import generate_rays
from ..render.integrator import RenderConfig, trace_rays
from .replay import (plan_buckets, record_paths, record_paths_pool,
                     trace_rays_replay)

__all__ = ["DIFF_FIELDS", "split_params", "merge_params", "ray_radiance",
           "render_loss", "render_loss_and_grads",
           "render_loss_and_grads_tape", "render_loss_and_grads_bucketed",
           "sgd_step", "make_optimizer", "make_fit_step",
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
    return generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ray_ids,
                         rng.camera_uniforms(key, ray_ids))


def ray_radiance(params, scene, camera, cfg: RenderConfig, key, ray_ids,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 method: str = "replay", record_pool: int = 0):
    """(R, 3) radiance as a differentiable function of ``params``.

    ``method="replay"``: record the primitive tape outside autograd (the
    lockstep recorder, or the pool recorder with ``record_pool`` slots),
    then replay it.  ``method="scan"``: the wavefront integrator with
    ``differentiable=True``.  The closest hit is ``intersect_fn`` on
    ``accel`` (``render.integrator.default_intersect`` by default); an
    accel built from other parameters than ``params`` is used as it is.
    """
    scene = merge_params(scene, params)
    o, d = _rays(camera, cfg, key, ray_ids)
    if method == "replay":
        if record_pool:
            tape = record_paths_pool(scene, camera, cfg, key, ray_ids,
                                     accel, intersect_fn,
                                     pool_size=record_pool)
        else:
            tape = record_paths(scene, o, d, ray_ids, key, cfg, accel,
                                intersect_fn)
        return trace_rays_replay(scene, o, d, ray_ids, key, cfg, tape)
    if method != "scan":
        raise ValueError(f"unknown method {method!r}")
    return trace_rays(scene, o, d, ray_ids, key,
                      dataclasses.replace(cfg, differentiable=True),
                      accel=accel, intersect_fn=intersect_fn)


def render_loss(params, scene, camera, cfg, key, ray_ids, target,
                accel=None, intersect_fn: Optional[Callable] = None,
                method: str = "replay", record_pool: int = 0):
    """Mean squared error between rendered per-ray radiance and ``target``."""
    rad = ray_radiance(params, scene, camera, cfg, key, ray_ids, accel,
                       intersect_fn, method=method, record_pool=record_pool)
    return torch.mean((rad - target) ** 2)


def _value_and_grad(loss_fn, params):
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
                          method: str = "replay", record_pool: int = 0):
    """(loss, grads) of ``render_loss``."""
    return _value_and_grad(
        lambda p: render_loss(p, scene, camera, cfg, key, ray_ids, target,
                              accel, intersect_fn, method=method,
                              record_pool=record_pool),
        params)


def render_loss_and_grads_tape(params, scene, camera, cfg, key, ray_ids,
                               target, tape):
    """(loss, grads) for a recorded (possibly ``live_trips``-trimmed)
    primitive tape: only the replay is differentiated."""
    o, d = _rays(camera, cfg, key, ray_ids)

    def loss(p):
        rad = trace_rays_replay(merge_params(scene, p), o, d, ray_ids, key,
                                cfg, tape)
        return torch.mean((rad - target) ** 2)

    return _value_and_grad(loss, params)


def render_loss_and_grads_bucketed(params, scene, camera, cfg, key,
                                   ray_ids, target, tape, plan=None,
                                   max_groups: int = 4):
    """(loss, grads) replaying depth-sorted ray buckets (``plan_buckets``):
    each bucket replays only its own trip count, so the replay's work is
    about R x the mean path length instead of R x the deepest.  Equal to
    ``render_loss_and_grads_tape`` on the whole tape up to f32 summation
    order.

    ``plan`` (from ``plan_buckets(tape, max_groups)``) may be passed so
    that repeated calls on one tape skip the host-side sort.  The default
    of 4 groups here against 6 in ``plan_buckets`` is the JAX package's,
    kept on purpose so that both packages plan the same buckets.
    """
    if plan is None:
        plan = plan_buckets(tape, max_groups)
    order, groups = plan
    order = order.to(tape.device)
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
        return total / (target.shape[0] * target.shape[1])

    return _value_and_grad(loss, params)


def sgd_step(params, scene, camera, cfg, key, ray_ids, target,
             lr: float = 0.05, accel=None,
             intersect_fn: Optional[Callable] = None):
    """One inverse-rendering SGD step; returns (loss, new_params)."""
    loss, grads = render_loss_and_grads(params, scene, camera, cfg, key,
                                        ray_ids, target, accel, intersect_fn)
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


def _apply(optimizer, params, grads):
    for k, p in params.items():
        p.grad = grads[k]
    optimizer.step()


def make_fit_step(scene, camera, cfg, ray_ids, target, optimizer,
                  accel=None, intersect_fn: Optional[Callable] = None,
                  device="cuda"):
    """Inverse-rendering step around a ``torch.optim`` optimizer.

    Returns ``step(params, key) -> loss``: the gradient of the MSE loss
    (``render_loss_and_grads``, closest hit by ``intersect_fn`` on
    ``accel``) followed by ``optimizer.step()``, which updates ``params``
    in place; the optimizer must have been built over ``params``' tensors,
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
                                            intersect_fn)
        _apply(optimizer, params, grads)
        return loss

    return step


def make_fit_step_replay(scene, camera, cfg, ray_ids, target, optimizer,
                         max_groups: int = 4, device="cuda"):
    """Inverse-rendering step on the record->replay path.

    Per step: repack the current scene for the recorder, record the
    primitive tape, plan depth buckets and differentiate only the bucketed
    replay, then ``optimizer.step()``.  The recorder follows the scene and
    the ray ids:

    - contiguous ids below 2^24 and at most 1024 spheres and 1024
      triangles: K2b, ``record_paths_mega`` on the dense pack;
    - contiguous ids and a larger scene (below 2^24 primitives): K3t,
      ``record_paths_mega_clustered`` on the clustered pack.  Its
      ``ClusterLayout`` is frozen here, so every step keeps the cluster
      memberships while boxes and payload follow the current parameters;
    - ids that are not contiguous or reach past 2^24: the wavefront
      ``record_paths``.

    Each recorder is the CUDA kernel on a GPU and its plain version on the
    CPU.  Returns ``step(params, key) -> loss``; as in ``make_fit_step``,
    ``params`` are updated in place and live on ``device``.
    """
    from ..kernels.megakernel_clustered import pack_scene_mega_clustered
    from ..kernels.record_mega import (pack_scene_mega, record_paths_mega,
                                       record_paths_mega_clustered)

    dev = torch.device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    ray_ids, target = ray_ids.to(dev), target.to(dev)
    ids_np = ray_ids.cpu().numpy()
    n = len(ids_np)
    contiguous = bool((np.diff(ids_np) == 1).all()) if n else True
    ray0 = int(ids_np[0]) if n else 0
    in_range = contiguous and ray0 + n <= MAX_RAY_ID
    use_kernel = (in_range and max(scene.num_spheres, scene.num_triangles)
                  <= DENSE_MAX)
    use_clustered = (not use_kernel and in_range
                     and scene.num_primitives < MAX_RAY_ID)
    layout = None
    if use_clustered:
        _, layout = pack_scene_mega_clustered(scene, camera,
                                              return_layout=True, device=dev)

    def step(params, key):
        s = merge_params(scene, {k: v.detach() for k, v in params.items()})
        if use_kernel:
            tape = record_paths_mega(pack_scene_mega(s, dev), camera, cfg,
                                     key, ray0=ray0, num_rays=n)
        elif use_clustered:
            pack = pack_scene_mega_clustered(s, camera, layout=layout,
                                             device=dev)
            tape = record_paths_mega_clustered(pack, camera, cfg, key,
                                               ray0=ray0, num_rays=n)
        else:
            o, d = _rays(camera, cfg, key, ray_ids)
            tape = record_paths(s, o, d, ray_ids, key, cfg)
        loss, grads = render_loss_and_grads_bucketed(
            params, scene, camera, cfg, key, ray_ids, target, tape,
            max_groups=max_groups)
        _apply(optimizer, params, grads)
        return loss

    return step
