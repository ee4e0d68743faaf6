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
reference.  The gradient step's loops too: a bounce of the lockstep
recorder (``diff/replay.py::record_bounce``, with the stand-in), a pass of
the pool recorder (``record_pool_pass``), the recorder's init from the
camera (``camera_record_state``), a pass of the occupancy scan
(``utils/metrics.py::_length_pass``), the dense sweep
(``intersect_brute``, the recorder's closest hit without an accel), and
the value and gradient of the whole-tape replay
(``diff/grad.py::tape_loss_and_grads``): its ops a tape row, from tapes
of 2 and 10 rows, and its ops on 2 rows (the rows do not all cost the
same, so the two do not split into a fixed part).  The CPU also takes sqrt, sin and cos
in float64 and rounds once (``core/vecmath.py``), a few ops the card does
not run.

Each count is printed three times: with the draws, camera rays and the
pass's two seams as the CPU runs them (``core/rng.uniforms_plain``,
``render/camera.generate_rays``, ``render/wavefront_pass.shade_plain``
and ``regenerate_plain``: their torch ops); under ``"with K7 and K8"``,
with each call of ``core.rng.uniforms`` (K7) and
``render.camera.camera_rays`` (K8) counted as one op, as the card
launches each as one kernel; under ``"with K7 to K10"``, also with
the pass's shading and compaction counted as one op (K9) and its
regeneration as one (K10, which writes the cursor), as the card runs
them; and under ``"with K7 to K13"``, also with the recorders' seams
(``diff/record_pass.py``: ``record_step_plain``, K12 in lockstep and
length modes; ``record_shade_plain``, K12 in pool mode;
``record_regenerate_plain``, K13) and the dense sweep (``dense_sweep``,
K11) counted as one op each.  The recorders' plain seams draw through
``uniforms_plain`` and ``camera_rays_plain`` themselves, so before the
last line their draws count as torch ops.  Stand-ins run the plain
versions with the count paused.

    python probes/wavefront_ops.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.render import api  # noqa: E402
from first_raytracer_tpu_torch.render import camera  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as dg  # noqa: E402
from first_raytracer_tpu_torch.diff import record_pass  # noqa: E402
from first_raytracer_tpu_torch.diff import replay as rp  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
from first_raytracer_tpu_torch.render import regenerative as reg  # noqa: E402,E501
from first_raytracer_tpu_torch.render import wavefront_pass as wp  # noqa: E402,E501
from first_raytracer_tpu_torch.render.api import batch_state  # noqa: E402
from first_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    intersect_brute, trip)
from first_raytracer_tpu_torch.utils import metrics  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += not self.paused
        return func(*args, **(kwargs or {}))


ACTIVE = []  # the Count of the running ``ops``


def ops(fn):
    with Count() as c:
        ACTIVE.append(c)
        try:
            fn()
        finally:
            ACTIVE.pop()
    return c.ops


def one_op(fn):
    """``fn`` counted as one op, its own ops not counted: a kernel's one
    launch."""
    def stand_in(*args, **kwargs):
        c = ACTIVE[-1] if ACTIVE else None
        if c is None:
            return fn(*args, **kwargs)
        c.paused = True
        try:
            return fn(*args, **kwargs)
        finally:
            c.paused = False
            c.ops += 1
    return stand_in


def with_kernels():
    """Routes the draws and camera rays of every body through ``one_op``
    stand-ins of K7 and K8."""
    rng.uniforms = one_op(rng.uniforms)
    rays = one_op(camera.camera_rays)
    for module in (camera, reg, api, rp, dg):
        module.camera_rays = rays


def with_pass_kernels():
    """Routes the pool pass's and the trip's seams through stand-ins of K9
    and K10 (one op each)."""
    wp.shade_plain = one_op(wp.shade_plain)
    wp.regenerate_plain = one_op(wp.regenerate_plain)


def with_record_kernels():
    """Routes the recorders' seams through stand-ins of K12 and K13, and
    the dense sweep through one of K11 (one op each)."""
    global intersect_brute
    for name in ("record_step_plain", "record_shade_plain",
                 "record_regenerate_plain"):
        setattr(record_pass, name, one_op(getattr(record_pass, name)))
    intersect_brute = one_op(intersect_brute)


def counts():
    """Each body's ops, as the module docstring lists them."""
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
    rec_in = dict(scene=scene, camera=cam, accel=pack, key=key,
                  ray_ids=ids)
    rec_static = dict(cfg=cfg, intersect_fn=stand_in, pool_size=C)
    rec = rp.camera_record_state(**rec_in, **rec_static)
    rp.record_bounce(rec, **rec_in, **rec_static)
    rpool = rp.record_pool_state(**rec_in, **rec_static)
    rp.record_pool_pass(rpool, **rec_in, **rec_static)
    lengths = metrics._length_state(**rec_in, **rec_static)
    metrics._length_pass(lengths, **rec_in, **rec_static)
    params, _ = dg.split_params(scene)
    target = torch.zeros((C, 3))

    def replay(rows):
        tape = torch.full((rows, C), -1, dtype=torch.int32)
        return ops(lambda: dg.tape_loss_and_grads(
            params, scene, cam, key, ids, target, tape, cfg=cfg))

    replay(2)
    row = (replay(10) - replay(2)) / 8
    return {"record_bounce": ops(lambda: rp.record_bounce(
                rec, **rec_in, **rec_static)),
            "record_pool_pass": ops(lambda: rp.record_pool_pass(
                rpool, **rec_in, **rec_static)),
            "camera_record_state": ops(lambda: rp.camera_record_state(
                **rec_in, **rec_static)),
            "length_pass": ops(lambda: metrics._length_pass(
                lengths, **rec_in, **rec_static)),
            "dense_sweep": ops(lambda: intersect_brute(scene, o, d,
                                                       cfg.t_min)),
            "replay_per_row": row,
            "replay_2_rows": replay(2),
            "pool_pass": ops(lambda: reg.pool_pass(state, **pool_in,
                                                   **pool_static)),
            "trip": ops(lambda: trip(chunk, **batch_in, **batch_static)),
            "batch_state": ops(lambda: batch_state(**batch_in,
                                                   **batch_static)),
            "camera_draw": ops(lambda: rng.camera_uniforms(key, ids)),
            "bounce_draw": ops(lambda: rng.bounce_uniforms(
                key, ids, state["depth"])),
            "k4_plain": ops(lambda: ip.intersect_pallas_reference(
                scene, pack, o, d, cfg.t_min))}


def main():
    print(counts())
    with_kernels()
    print({"with K7 and K8": counts()})
    with_pass_kernels()
    print({"with K7 to K10": counts()})
    with_record_kernels()
    print({"with K7 to K13": counts()})


if __name__ == "__main__":
    main()
