"""ATen ops of one wavefront pass, counted on the CPU.

Each op a pass dispatches is a kernel launch eager on the card and a node
of its CUDA graph (``render/graphed.py``).  Counted with a
``TorchDispatchMode`` on random-spheres 32x16 @ 4 (the op count does not
depend on the size), the closest hit replaced by a stand-in that returns
precomputed hits, so that the count is the pass's own: on the card the
closest hit is one K4 or K5 launch.  Prints the ops of a pool pass
(``pool_pass``), of a chunk's trip (``trip``), of a chunk's init
(``batch_state``: its camera rays), of the pass's two Threefry draws
(the camera draw and the bounce draw) and of K4's plain version, for
reference.  The CPU also takes sqrt, sin and cos in float64 and rounds
once (``core/vecmath.py``), a few ops the card does not run.

    python probes/wavefront_ops.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
from first_raytracer_tpu_torch.render import regenerative as reg  # noqa: E402,E501
from first_raytracer_tpu_torch.render.api import batch_state  # noqa: E402
from first_raytracer_tpu_torch.render.integrator import trip  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def ops(fn):
    with Count() as c:
        fn()
    return c.ops


def main():
    scene, cam, cfg = build_preset("random-spheres", device="cpu", nx=32,
                                   ny=16, spp=4)
    pack = ip.pack_scene_pallas(scene)
    key = rng.base_key(0)
    C = 256
    ids = torch.arange(C)
    o, d = reg._fresh_rays(cam, cfg, key, ids)
    hits = ip.intersect_pallas_reference(scene, pack, o, d, cfg.t_min)

    def stand_in(scene_, accel, o_, d_, t_min):
        return hits

    pool_in = dict(scene=scene, camera=cam, accel=pack, key=key,
                   start_id=torch.zeros((), dtype=torch.int64))
    pool_static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=C,
                       intersect_fn=stand_in)
    state = reg.pool_state(**pool_in, **pool_static)
    reg.pool_pass(state, **pool_in, **pool_static)  # warm: constants made
    batch_in = dict(scene=scene, camera=cam, accel=pack, key=key,
                    ray_ids=ids)
    batch_static = dict(cfg=cfg, intersect_fn=stand_in)
    chunk = batch_state(**batch_in, **batch_static)
    trip(chunk, **batch_in, **batch_static)
    print({"pool_pass": ops(lambda: reg.pool_pass(state, **pool_in,
                                                   **pool_static)),
           "trip": ops(lambda: trip(chunk, **batch_in, **batch_static)),
           "batch_state": ops(lambda: batch_state(**batch_in,
                                                  **batch_static)),
           "camera_draw": ops(lambda: rng.camera_uniforms(key, ids)),
           "bounce_draw": ops(lambda: rng.bounce_uniforms(
               key, ids, state["depth"])),
           "k4_plain": ops(lambda: ip.intersect_pallas_reference(
               scene, pack, o, d, cfg.t_min))})


if __name__ == "__main__":
    main()
