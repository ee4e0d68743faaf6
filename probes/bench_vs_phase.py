"""The regenerative final-scene frame timed two ways in one process.

``chip_smoke.py`` phase 12 times ``render_image(mode="regenerative")``
(host clock, median of 3 after a warm run); ``bench_torch.py`` times
``render_rays_regenerative`` on the same pack and pool.  In PR 9's chip
runs the bench, a fresh process, read 1.25x the phase's time.  This probe
times the phase's way, then the bench's ``measure``, then the phase's way
again, all in one process, and prints one JSON line of seconds per frame:
if the three agree, the gap lies in the process (a fresh one against
``chip_smoke.py``'s long-lived one), not in the bench's code.

    python probes/bench_vs_phase.py
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from first_raytracer_tpu_torch import bench  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
from first_raytracer_tpu_torch.render.api import render_image  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501


def phase_s(scene, cam, cfg, pack):
    """Phase 12's reading: median of 3 host-clock frames after a warm one."""
    def frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(scene, cam, cfg, seed=0, accel=pack,
                     mode="regenerative", pool_size=1 << 17, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    frame()
    return statistics.median(frame() for _ in range(3))


def main():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = ip.pack_scene_pallas(scene)
    before = phase_s(scene, cam, cfg, pack)
    m = bench.measure({"BENCH_MODE": "regenerative"})
    after = phase_s(scene, cam, cfg, pack)
    print(json.dumps({"phase_before_s": before, "bench_s": m.seconds,
                      "bench_times": m.times, "phase_after_s": after,
                      "device": bench.device_line(torch.device("cuda"))}))


if __name__ == "__main__":
    main()
