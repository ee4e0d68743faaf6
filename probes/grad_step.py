"""The record->replay gradient step of one checkout, for comparing commits.

On the final scene (random-spheres, 1200x800 @ 10, depth 50) at ray ids
[0, 2^17), zero target, every differentiable field (``chip_smoke.py``
phase 6's step): K2b records the tape, ``plan_buckets`` sorts it, and
``render_loss_and_grads_bucketed`` differentiates the bucketed replay.
Prints one JSON line: the host seconds of the whole step and of the
replay's value and gradient alone (each the median of 5 after a warm
step, with all 5), the peak device memory of one step, and the loss and
the largest albedo gradient (so that two checkouts can be seen to
compute the same step).

Run from the repository root on a GPU host, each checkout in its own
process, in turns (parent, change, change, parent):

    git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        python probes/grad_step.py $t; done

The checkout's own package is imported (its path goes first on
sys.path), so the parent is measured with its own replay and kernels.
"""
import json
import statistics
import sys
import time

CHECKOUT = sys.argv[1]
sys.path.insert(0, CHECKOUT)

import torch  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as dg  # noqa: E402
from first_raytracer_tpu_torch.diff.replay import plan_buckets  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels import record_mega as rm  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

RAYS = 1 << 17


def seconds(fn, repeats=5):
    """Sorted host seconds of ``fn`` and the work it queued, ``repeats``
    runs after a warm one."""
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)


def main():
    dev = torch.device("cuda")
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    key = rng.base_key(0)
    pack = mk.pack_scene_mega(scene)
    ids = torch.arange(RAYS, device=dev)
    target = torch.zeros((RAYS, 3), device=dev)
    params, _ = dg.split_params(scene)
    tape = rm.record_paths_mega(pack, cam, cfg, key, num_rays=RAYS)
    plan = plan_buckets(tape)

    def step():
        t = rm.record_paths_mega(pack, cam, cfg, key, num_rays=RAYS)
        return dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, t,
            plan=plan_buckets(t))

    def replay():
        return dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=plan)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = seconds(step)
    replay_s = seconds(replay)
    print(json.dumps({
        "checkout": CHECKOUT, "step_s": statistics.median(step_s),
        "step_s_all": step_s, "replay_s": statistics.median(replay_s),
        "replay_s_all": replay_s, "peak_gb": peak, "loss": float(loss),
        "albedo_grad_absmax": float(grads["albedo"].abs().max())}),
        flush=True)


if __name__ == "__main__":
    main()
