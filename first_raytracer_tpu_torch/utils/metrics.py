"""Render metrics: wavefront occupancy and the megakernels' lane
occupancy, logged through the standard ``logging`` module.

Port of ``first_raytracer_tpu.utils.metrics``.  ``wavefront_occupancy``
is integrator work (the rays alive at each bounce of an instrumented pass
of the wavefront loop), so its counts equal the JAX package's.  The
megakernels' occupancy is a property of the kernels, and the port's
differ from the TPU's: there a lane of a 128-lane tile runs its pixels'
paths in turn and occupancy counts lane-iterations of the tile's trips;
here a warp of 32 lanes takes the next unstarted sample whenever a path
ends, and ``lane_occupancy`` is the warp lane efficiency that
``chip_smoke.py`` reports: segments / (32 x the warps' segment steps).
On the CPU the plain versions run, and their steps are those of a warp
whose lanes each trace one pixel's samples in turn
(``megakernel.pixel_lane_steps``).
"""
from __future__ import annotations

import json
import logging

import numpy as np
import torch

from ..core import rng
from ..diff.record_pass import record_step
from ..diff.replay import camera_record_state
from ..render.integrator import RenderConfig, closest_hit, default_intersect

logger = logging.getLogger("first_raytracer_tpu_torch")

__all__ = ["wavefront_occupancy", "megakernel_occupancy",
           "megakernel_clustered_occupancy", "log_metrics", "logger"]

_WARP = 32


def _length_state(camera, key, ray_ids, *, cfg, **_):
    """The lockstep recorder's state of the camera rays, without a tape,
    and each ray's ``length``: the bounces it entered alive."""
    state = camera_record_state(camera, key, ray_ids, cfg=cfg, tape=False)
    state["length"] = torch.zeros(ray_ids.shape, dtype=torch.int64,
                                  device=ray_ids.device)
    return state


@torch.no_grad()
def _length_pass(state, *, scene, accel, key, ray_ids, cfg, intersect_fn,
                 **_):
    """One bounce of the recorder, counting the rays that enter it alive:
    the body of the JAX package's ``_occupancy_scan``.  The closest hit,
    then ``diff.record_pass.record_step`` in its length mode (K12 on a
    CUDA device), which also advances the counter."""
    prim, _, hit = closest_hit(intersect_fn, scene, accel, state["o"],
                               state["dr"], cfg.t_min, state["alive"])
    record_step(state, prim, hit, scene=scene, key=key, ray_ids=ray_ids,
                cfg=cfg)


@torch.no_grad()
def _path_lengths(scene, camera, cfg, key, ray_ids, accel, graphed=None):
    """(R,) int64 segments each ray traced: the integrator's bounce loop,
    keeping only each ray's count of bounces it entered alive (a pass of
    its own, so that the render path carries no counter), through
    ``render.graphed.run_loop`` (CUDA graphs on the card unless
    ``graphed=False``)."""
    from ..render.graphed import run_loop
    return run_loop(_length_state, _length_pass, dict(
        cfg=cfg, intersect_fn=default_intersect), dict(
        scene=scene, accel=accel, key=key, camera=camera, ray_ids=ray_ids),
        ray_ids.device, ("length",), graphed)["length"]


def wavefront_occupancy(scene, camera, cfg: RenderConfig, seed: int = 0,
                        accel=None, num_rays: int = 1 << 14,
                        device="cuda", graphed=None) -> dict:
    """Occupancy report for the first ``num_rays`` rays of a render: the
    rays alive per bounce and their fraction, the bounce histogram (paths
    ending at each depth), the mean path length and the wavefront
    efficiency (alive rays over rays x the bounces with any alive).  The
    scene, camera and accel go to ``device``; ``graphed`` is the loop's
    route (``render.graphed.graphed_route``: ``graphed=False`` runs it op
    by op)."""
    device = torch.device(device)
    scene, camera = scene.to(device), camera.to(device)
    if accel is not None:
        accel = accel.to(device)
    ids = torch.arange(min(num_rays, cfg.num_rays), dtype=torch.int64,
                       device=device)
    lengths = _path_lengths(scene, camera, cfg, rng.base_key(seed), ids,
                            accel, graphed).cpu().numpy()
    # Rays alive at each bounce: those whose paths are longer.
    ended = np.bincount(lengths, minlength=cfg.max_depth + 2)
    total = int(ids.shape[0])
    counts = total - np.cumsum(ended)[:cfg.max_depth + 1]
    terminated = -np.diff(np.append(counts, 0))
    return {
        "rays": total,
        "alive_per_bounce": counts.tolist(),
        "alive_frac_per_bounce": [round(float(x), 4)
                                  for x in counts / total],
        "bounce_histogram": terminated.tolist(),
        "avg_path_length": float(counts.sum()) / total,
        "wavefront_efficiency": float(counts.sum())
        / (total * max(int(np.sum(counts > 0)), 1)),
    }


def log_metrics(tag: str, metrics: dict, level=logging.INFO):
    logger.log(level, "%s %s", tag, json.dumps(metrics))


def _lane_report(segs, steps, cfg):
    """The occupancy keys of the JAX package's report from per-pixel
    segments and the warps' steps (nonzero at each warp's first pixel):
    ``tile_trips_*`` are the warps' segment steps."""
    total = int(segs.long().sum())
    warps = steps.long()[steps > 0]
    slots = _WARP * int(warps.sum())
    return {
        "segments": total,
        "mean_path_len": round(total / cfg.num_rays, 3),
        "tile_trips_mean": round(float(warps.double().mean()), 1)
        if warps.numel() else 0.0,
        "tile_trips_max": int(warps.max()) if warps.numel() else 0,
        "lane_occupancy": round(total / slots, 4) if slots else 0.0,
    }


def megakernel_occupancy(scene, camera, cfg: RenderConfig, seed: int = 0,
                         device="cuda") -> dict:
    """Lane occupancy of the megakernel (K1 on a GPU, its plain version on
    the CPU): the frame's segments, the mean path length, the warps' steps
    and the warp lane efficiency, segments / (32 x the warps' steps).

    Not the JAX package's TPU count (lanes x the tiles' trips): the port's
    warps regenerate their lanes' paths, so the efficiency measures how
    busy a warp's lanes stay, not how long a tile's longest path is."""
    from ..kernels import megakernel as mk

    device = torch.device(device)
    pack = mk.pack_scene_mega(scene, device)
    _, segs, steps = mk.render_pixels_mega(pack, camera.to(device), cfg,
                                           rng.base_key(seed),
                                           return_iters=True)
    return _lane_report(segs, steps, cfg)


def megakernel_clustered_occupancy(scene, camera, cfg: RenderConfig,
                                   seed: int = 0, device="cuda") -> dict:
    """Lane occupancy of the clustered megakernel (K3, or its plain
    version on the CPU), as ``megakernel_occupancy``, with the cluster
    count and ``sweeps_per_iter``: the clusters a warp swept per step,
    from K3's counters (its warps sweep each cluster one of their lanes
    opens once); the plain version's ungated sweep gives every cluster,
    as the JAX package's ungated count would."""
    from ..kernels import megakernel as mk
    from ..kernels import megakernel_clustered as mc

    device = torch.device(device)
    pack = mc.pack_scene_mega_clustered(scene, camera, device=device)
    _, segs, sweeps = mc.render_pixels_mega_clustered(
        pack, camera.to(device), cfg, rng.base_key(seed), return_iters=True)
    sweeps = sweeps.long()
    if device.type == "cpu":
        steps = mk.pixel_lane_steps(segs)
        per_step = float(sweeps[:, 0].sum()) / max(int(segs.sum()), 1)
    else:
        steps = sweeps[:, 5]
        per_step = float(sweeps[:, 4].sum()) / max(int(steps.sum()), 1)
    out = _lane_report(segs, steps, cfg)
    out["clusters"] = pack.clusters
    out["sweeps_per_iter"] = round(per_step, 2)
    return out
