"""Single-device forward step of the flagship workload.

The twin of the JAX package's ``__graft_entry__.entry()`` (and
``parallel/dryrun.py`` is the twin of its ``dryrun_multichip``):
``entry(device)`` returns ``(fn, example_args)``, where ``fn(*example_args)``
renders 8192 consecutive ray ids of the random-spheres final scene at
128x64 @ 2 spp through the wavefront integrator with the flat-BVH walk,
(8192, 3) float32 radiance.  It runs on the card unless the caller asks for
``device="cpu"``; there the walk is K6 and the batch's loop replays as CUDA
graphs (``render/graphed.py``).
"""
from __future__ import annotations

import torch

from .accel.build import build_bvh
from .core import rng
from .render.api import render_ray_batch
from .scene.builders import random_scene

__all__ = ["entry"]


def entry(device="cuda"):
    """Returns (fn, example_args): a forward render step and its inputs,
    every tensor on ``device``."""
    device = torch.device(device)
    scene, camera, cfg = random_scene(nx=128, ny=64, spp=2, device=device)
    accel = build_bvh(scene, max_leaf=4)
    key = rng.base_key(0)
    ray_ids = torch.arange(8192, dtype=torch.int64, device=device)

    def forward(scene, camera, key, ray_ids, accel):
        return render_ray_batch(scene, camera, cfg, key, ray_ids, accel)

    return forward, (scene, camera, key, ray_ids, accel)
