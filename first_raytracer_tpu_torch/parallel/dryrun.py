"""The sharded paths end to end, over every rank of a process group.

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``: its
six steps, each through this package's entry points, on a mesh of all the
ranks of the group that ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts:

1. the wavefront render, ``render_image_distributed`` with the dense
   closest hit K4 (``accel=pack_scene_pallas(scene)``), pixels split over
   the ranks (tiles, 1), then samples split over them (1, spp);
2. a training step: ``render_loss_and_grads_sharded`` (each rank records
   its block's tape and replays the CUDA graph of its value and gradient,
   then the sum over the ranks) and an SGD update;
3. the sharded megakernel, ``render_image_mega_sharded`` (K1);
4. the ring-sharded scene, ``render_image_ring``, and the global ids of
   the closest hits of each rank's camera rays (``ring_closest_hit``);
5. the record->replay gradient, ``render_loss_and_grads_replay_sharded``
   (K2b records each rank's block of ray ids);
6. the sharded clustered megakernel,
   ``render_image_mega_clustered_sharded`` (K3).

Run it as

    torchrun --nproc-per-node 2 -m first_raytracer_tpu_torch.parallel.dryrun \\
        --out out/dryrun

Each rank writes ``rank<r>.npz`` into ``--out``: every image, loss,
gradient and tape, the kernels' launch counts of each step, the transports
its collectives took, the CUDA graphs the training and replay steps
captured and replayed (``diff.grad.GRAPHS``, by step), and for the
megakernel frames the seconds of three timed frames after a warm one and
of an all-gather of the frame's shape alone (the gather's share); on a
CUDA device also the training step's seconds, op by op and graphed.
``--size small`` renders
small scenes (the CPU tests' size); ``--size chip`` the configurations of
the package's H100 checks (``chip_smoke.py`` phase 15).  One process (no
``WORLD_SIZE``) runs the same steps without collectives.  It imports no
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..core import rng
from ..diff import grad as dg
from ..kernels import intersect_pallas as ip
from ..kernels import megakernel as mk
from ..kernels import megakernel_clustered as mc
from ..kernels import record_mega as rm
from ..render.camera import camera_rays
from ..scene.builders import build_preset
from . import ring, shard
from .mesh import (TILE_AXIS, initialize_distributed, local_device,
                   make_render_mesh)

__all__ = ["SIZES", "main"]

# Per step: (preset, builder arguments, max_depth or None).
SIZES = {
    "small": {
        "wavefront": ("three-spheres", dict(nx=24, ny=12, spp=2), None),
        "train": ("three-spheres", dict(nx=24, ny=12, spp=2), 6),
        "mega": ("three-spheres", dict(nx=24, ny=12, spp=2), None),
        "ring": ("three-spheres", dict(nx=24, ny=12, spp=2), None),
        "replay": ("random-spheres", dict(nx=16, ny=8, spp=2), None),
        "clustered": ("triangle-mesh", dict(nx=24, ny=12, spp=2), 8),
    },
    "chip": {
        "wavefront": ("random-spheres", dict(nx=120, ny=80, spp=4), None),
        # JAX's train_step fields over ray ids [0, 2^17) of the final
        # scene at its depth of 50, 2^16 a rank on two.
        "train": ("random-spheres", {}, None),
        "mega": ("random-spheres", {}, None),
        "ring": ("random-spheres", dict(nx=64, ny=32, spp=2), None),
        # bench.py's grad configuration: ray ids [0, 2^17) of the final
        # scene.
        "replay": ("random-spheres", {}, None),
        "clustered": ("sphere-field", dict(n=20000), None),
    },
}
# The ray ids [0, n) of the training and replay steps (None: every ray of
# the frame).
REPLAY_RAYS = {"small": None, "chip": 1 << 17}
TRAIN_FIELDS = ("albedo", "sphere_center", "sphere_radius", "fuzz",
                "ref_idx")


def build(step, size, device):
    preset, kw, depth = SIZES[size][step]
    scene, cam, cfg = build_preset(preset, device=device, **kw)
    if depth is not None:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    return scene, cam, cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device, repeats=3):
    """Seconds of ``fn`` and what it queued, ``repeats`` runs after a warm
    one."""
    fn()
    out = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


def _gather_seconds(axis, shape, device, repeats=3):
    """Seconds of the tile axis's all-gather of a float32 ``shape`` alone,
    ``repeats`` runs after a warm one."""
    t = torch.zeros(shape, dtype=torch.float32, device=device)
    return _seconds(lambda: axis.all_gather(t), device, repeats)


def reset_counts():
    mk.render_pixels_mega.launches = 0
    mc.render_pixels_mega_clustered.launches = 0
    ip.intersect_pallas.launches = 0
    rm.record_paths_mega.launches = 0


def counts():
    return {"K1": mk.render_pixels_mega.launches,
            "K3": mc.render_pixels_mega_clustered.launches,
            "K4": ip.intersect_pallas.launches,
            "K2b": rm.record_paths_mega.launches}


def run(size, device):
    """The six steps on a mesh of every rank; returns this rank's results
    (a dict of arrays and JSON strings)."""
    world = make_render_mesh()
    n = world.size
    spp_mesh = make_render_mesh(1, n)
    out, launches, graphs = {}, {}, {}

    def step(name, fn):
        reset_counts()
        before = (dg.GRAPHS.captures, dg.GRAPHS.replays)
        result = fn()
        _sync(device)
        launches[name] = counts()
        graphs[name] = {"captures": dg.GRAPHS.captures - before[0],
                        "replays": dg.GRAPHS.replays - before[1]}
        return result

    # 1. The wavefront render with K4, pixels split, then samples split.
    scene, cam, cfg = build("wavefront", size, device)
    accel = ip.pack_scene_pallas(scene)
    out["wavefront_tiles"] = step("wavefront_tiles", lambda: (
        shard.render_image_distributed(scene, cam, cfg, world, accel=accel,
                                        device=device)))
    out["wavefront_spp"] = step("wavefront_spp", lambda: (
        shard.render_image_distributed(scene, cam, cfg, spp_mesh,
                                       accel=accel, device=device)))

    # 2. A training step: sharded rays, each rank's value and gradient a
    # replay of its graph, summed over the ranks, SGD.
    scene, cam, cfg = build("train", size, device)
    cfg = dataclasses.replace(cfg, differentiable=True)
    rays = REPLAY_RAYS[size] or cfg.num_rays
    params, _ = dg.split_params(scene, fields=TRAIN_FIELDS)
    ids = torch.arange(rays, device=device)
    target = torch.zeros((rays, 3), device=device)

    def train(graphed=None):
        return shard.render_loss_and_grads_sharded(
            params, scene, cam, cfg, rng.base_key(0), ids, target, world,
            graphed=graphed)

    loss, grads = step("train", train)
    out["train_loss"] = loss.cpu().numpy()
    lo, hi = world.ray_block(rays)
    out["train_tape"] = dg.record_tape(params, scene, cam, cfg,
                                       rng.base_key(0), ids[lo:hi]
                                       ).cpu().numpy()
    for k, g in grads.items():
        out[f"train_grad_{k}"] = g.cpu().numpy()
        out[f"train_param_{k}"] = (params[k] - 0.05 * g).detach().cpu(
        ).numpy()
    if device.type == "cuda":
        out["train_eager_s"] = np.array(_seconds(lambda: train(False),
                                                 device))
        out["train_s"] = np.array(_seconds(train, device))

    # 3. The sharded megakernel (K1).
    scene, cam, cfg = build("mega", size, device)
    out["mega"] = step("mega", lambda: mk.render_image_mega_sharded(
        scene, cam, cfg, world, device=device)).cpu().numpy()
    out["mega_s"] = np.array(_seconds(
        lambda: mk.render_image_mega_sharded(scene, cam, cfg, world,
                                             device=device), device))
    out["mega_gather_s"] = np.array(_gather_seconds(
        world.axis(TILE_AXIS), (-(-cfg.num_pixels // n), 3), device))

    # 4. The ring-sharded scene, and the global ids of the closest hits of
    # this rank's block of camera rays (the selection).
    scene, cam, cfg = build("ring", size, device)
    out["ring"] = step("ring", lambda: ring.render_image_ring(
        scene, cam, cfg, world, device=device)).cpu().numpy()
    axis = world.axis(TILE_AXIS)
    held, ns_total = ring.shard_scene(scene.to("cpu"), n, axis.index)
    per = cfg.num_rays // n
    ids = torch.arange(axis.index * per, (axis.index + 1) * per,
                       device=device)
    o, d = camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, rng.base_key(0), ids)
    _, gid = ring.ring_closest_hit(held.to(device), axis, ns_total, o, d,
                                   cfg.t_min)
    out["ring_gid"] = gid.cpu().numpy()

    # 5. The record->replay gradient, each rank's block recorded by K2b.
    scene, cam, cfg = build("replay", size, device)
    rays = REPLAY_RAYS[size] or cfg.num_rays
    params, _ = dg.split_params(scene)
    ids = torch.arange(rays, device=device)
    target = torch.zeros((rays, 3), device=device)
    loss, grads, tape = step(
        "replay", lambda: shard.render_loss_and_grads_replay_sharded(
            params, scene, cam, cfg, rng.base_key(0), ids, target, world))
    out["replay_loss"] = loss.cpu().numpy()
    out["replay_tape"] = tape.cpu().numpy()
    for k, g in grads.items():
        out[f"replay_grad_{k}"] = g.cpu().numpy()

    # 6. The sharded clustered megakernel (K3).
    scene, cam, cfg = build("clustered", size, device)
    out["clustered"] = step("clustered", lambda: (
        mc.render_image_mega_clustered_sharded(scene, cam, cfg, world,
                                               device=device))).cpu().numpy()
    out["clustered_s"] = np.array(_seconds(
        lambda: mc.render_image_mega_clustered_sharded(
            scene, cam, cfg, world, device=device), device))
    out["clustered_gather_s"] = np.array(_gather_seconds(
        world.axis(TILE_AXIS), (-(-cfg.num_pixels // n), 3), device))

    transports = sorted(set().union(
        *(m.world.transports | m.tiles_axis.transports | m.spp_axis.transports
          for m in (world, spp_mesh))))
    out["info"] = np.array(json.dumps({
        "rank": world.rank, "world": n, "device": str(device),
        "launches": launches, "transports": transports,
        "graphs": graphs}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="first_raytracer_tpu_torch.parallel."
                                     "dryrun")
    p.add_argument("--out", required=True,
                   help="directory for rank<r>.npz")
    p.add_argument("--size", default="small", choices=sorted(SIZES))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    args = p.parse_args(argv)
    # NCCL when each process has a GPU of its own, else gloo.
    initialize_distributed(None, int(os.environ.get("WORLD_SIZE", "1")),
                           int(os.environ.get("RANK", "0")))
    device = local_device(args.device)
    out = run(args.size, device)
    os.makedirs(args.out, exist_ok=True)
    rank = json.loads(str(out["info"]))["rank"]
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    print(str(out["info"]), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
