"""Mesh-sharded rendering and gradients over ``torch.distributed``.

Port of ``first_raytracer_tpu.parallel.shard``.  The ray population is an
``(npix, spp)`` grid of global ray ids; a rank of a (tiles, spp) mesh takes
its block of pixels (its tile index) and its block of samples (its spp
index).  The spp blocks' partial pixel means are combined with one
all-reduce over the spp axis, divided by the spp shard count; the pixel
blocks are assembled with one all-gather over the tile axis.  Scene,
camera and accel are replicated.  The RNG is keyed by global ray id, so
the image does not depend on the layout: a split of pixels only is
bit-equal to the single-process ``render_image`` (each pixel's samples
are added in sample order on one rank), a split of samples equal to it
within the image bound (another summation order).

The JAX package gets the gradient all-reduce from autodiff: the transpose
of the replicated parameters' broadcast is a ``psum``.  torch's autograd
sees only this rank's rays, so the sharded gradient functions here divide
each rank's sum of squares by the whole batch's value count and sum the
loss and every gradient over all ranks explicitly (``MeshAxis.all_reduce``
on the mesh's ``world`` axis, ``RenderMesh.sum_over_ranks``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from ..diff import grad as dg
from ..render.api import pixel_means, render_rays
from ..render.integrator import RenderConfig
from .mesh import SPP_AXIS, TILE_AXIS, local_device

__all__ = ["ray_id_grid", "render_image_sharded", "render_image_distributed",
           "render_image_auto", "render_loss_and_grads_sharded",
           "render_loss_and_grads_replay_sharded"]


def ray_id_grid(cfg: RenderConfig, device="cpu"):
    """(npix, spp) int64 grid of global ray ids, pixel-major."""
    return torch.arange(cfg.num_rays, dtype=torch.int64,
                        device=device).reshape(cfg.num_pixels, cfg.spp)


def _check_divisible(cfg, mesh):
    if cfg.num_pixels % mesh.tiles:
        raise ValueError(f"{cfg.num_pixels} pixels not divisible by "
                         f"{mesh.tiles} tile shards")
    if cfg.spp % mesh.spp:
        raise ValueError(f"spp={cfg.spp} not divisible by {mesh.spp}")


def _render_block(scene, camera, cfg, mesh, seed, accel, intersect_fn,
                  device, graphed):
    """This rank's (npix / tiles, 3) pixel means, combined over the spp
    axis."""
    _check_divisible(cfg, mesh)
    scene, camera = scene.to(device), camera.to(device)
    if accel is not None:
        accel = accel.to(device)
    npix, spp = cfg.num_pixels // mesh.tiles, cfg.spp // mesh.spp
    p0, s0 = mesh.tile_index * npix, mesh.spp_index * spp
    ids = ray_id_grid(cfg, device)[p0:p0 + npix, s0:s0 + spp].reshape(-1)
    rad = render_rays(scene, camera, cfg, rng.base_key(seed), ids, accel,
                      intersect_fn, graphed=graphed)
    part = pixel_means(rad, spp)
    if mesh.spp > 1:
        part = mesh.axis(SPP_AXIS).all_reduce(part) / mesh.spp
    return part


def render_image_sharded(scene, camera, cfg: RenderConfig, mesh,
                         seed: int = 0, accel=None,
                         intersect_fn: Optional[Callable] = None,
                         device="cuda", graphed: Optional[bool] = None):
    """Full-image wavefront render sharded over ``mesh``; (ny, nx, 3) on
    ``device``, row 0 = top, the whole image on every rank.  Each rank
    traces its rays in ``render_image``'s chunks (CUDA graphs on the card
    unless ``graphed=False``).

    Raises ``ValueError`` when the pixels do not divide over the tile axis
    or the samples over the spp axis.  Every rank of the mesh must call
    it.
    """
    device = local_device(device)
    part = _render_block(scene, camera, cfg, mesh, seed, accel,
                         intersect_fn, device, graphed)
    img = mesh.axis(TILE_AXIS).all_gather(part)
    return img.reshape(cfg.ny, cfg.nx, 3).flip(0)


def render_image_distributed(scene, camera, cfg: RenderConfig, mesh,
                             seed: int = 0, accel=None,
                             intersect_fn: Optional[Callable] = None,
                             device="cuda",
                             graphed: Optional[bool] = None) -> np.ndarray:
    """``render_image_sharded`` over a mesh that spans processes, returned
    as the complete host-side (ny, nx, 3) NumPy image on every rank, as the
    JAX package's multi-process render returns it."""
    return render_image_sharded(scene, camera, cfg, mesh, seed, accel,
                                intersect_fn, device, graphed).cpu().numpy()


def render_image_auto(scene, camera, cfg: RenderConfig, mesh, seed: int = 0,
                      accel=None, intersect_fn: Optional[Callable] = None,
                      device="cuda", graphed: Optional[bool] = None):
    """The JAX package's GSPMD render, where XLA's partitioner chooses the
    collectives.  torch has no such partitioner, so this is
    ``render_image_sharded`` on the mesh's ranks laid out tiles-only (every
    rank a block of pixels, all samples): one all-gather."""
    return render_image_sharded(scene, camera, cfg, mesh.tiles_only(), seed,
                                accel, intersect_fn, device, graphed)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def render_loss_and_grads_sharded(params, scene, camera, cfg, key, ray_ids,
                                  target, mesh, accel=None,
                                  intersect_fn: Optional[Callable] = None,
                                  method: str = "replay",
                                  graphed: Optional[bool] = None):
    """``diff.grad.render_loss_and_grads`` with the rays split over all the
    mesh's ranks: each rank differentiates the sum of squares of its block
    of ``ray_ids`` over the whole batch's value count, then the loss and
    every gradient are summed over the ranks, so that every rank holds the
    single-process loss and gradients (up to f32 summation order).  The
    tensors stay on their device.

    ``method="replay"``: the block's tape is recorded outside autograd
    (``diff.grad.record_tape``), then its value and gradient replay one
    CUDA graph a rank on the card (``render_loss_and_grads_tape`` with the
    count static).  ``method="scan"``: the differentiable scan's graph
    (``render_loss_and_grads_scan``).  ``graphed`` goes to the recorder and
    the body, or to the scan: ``graphed=False`` runs the step op by op.
    The sum over the ranks stays outside the graphs (a gloo collective
    stages through host tensors)."""
    lo, hi = mesh.ray_block(ray_ids.shape[0])
    ids, tgt = ray_ids[lo:hi], target[lo:hi]
    count = target.shape[0] * target.shape[1]
    if method == "replay":
        tape = dg.record_tape(params, scene, camera, cfg, key, ids, accel,
                              intersect_fn, graphed=graphed)
        loss, grads = dg.render_loss_and_grads_tape(
            params, scene, camera, cfg, key, ids, tgt, tape,
            num_values=count, graphed=graphed)
    elif method == "scan":
        loss, grads = dg.render_loss_and_grads_scan(
            params, scene, camera, cfg, key, ids, tgt, accel, intersect_fn,
            graphed=graphed, num_values=count)
    else:
        raise ValueError(f"unknown method {method!r}")
    return mesh.sum_over_ranks(loss, grads)


def render_loss_and_grads_replay_sharded(params, scene, camera, cfg, key,
                                         ray_ids, target, mesh,
                                         max_groups: int = 4):
    """The record->replay gradient with the rays split over all the mesh's
    ranks (``diff.grad.render_loss_and_grads_recorded`` on a mesh): each
    rank records its block of ``ray_ids`` (K2b on the dense pack for
    contiguous ids of a scene of up to 1024 spheres and 1024 triangles, as
    ``diff.grad.tape_recorder`` chooses), plans its buckets and
    differentiates its bucketed replay over the whole batch's value count;
    then the loss and every gradient are summed over the ranks.  Returns
    ``(loss, grads, tape)``, the tape this rank's.  ``make_fit_step_replay``
    with a ``mesh`` takes the optimizer's step after it."""
    lo, hi = mesh.ray_block(ray_ids.shape[0])
    record = dg.tape_recorder(scene, camera, cfg, ray_ids[lo:hi],
                              ray_ids.device)
    return dg.render_loss_and_grads_recorded(
        params, scene, camera, cfg, key, ray_ids, target, record,
        max_groups=max_groups, mesh=mesh)
