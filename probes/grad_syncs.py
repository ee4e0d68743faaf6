"""The host synchronizations inside ``bench_torch.py``'s grad step.

Builds the bench's grad configuration (``BENCH_MODE=grad``; the scene
from ``--scene``, empty for the final scene) with a pipeline of one step,
runs the step once to warm it, then once more under
``torch.cuda.set_sync_debug_mode("warn")`` and prints one JSON line: the
number of synchronizing CUDA calls the step made and the source lines
that made them.  A step without any can be queued back to back with the
next one; each one found makes the host wait for the card inside the
bench's pipeline.

    python probes/grad_syncs.py                    # final scene, K2b
    python probes/grad_syncs.py --scene field5000  # K3t
"""
import argparse
import collections
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from first_raytracer_tpu_torch import bench  # noqa: E402
from first_raytracer_tpu_torch.core import rng  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="")
    args = ap.parse_args()
    dev = torch.device("cuda")
    env = {"BENCH_MODE": "grad", "BENCH_SCENE": args.scene,
           "BENCH_GRAD_PIPELINE": "1"}
    scene, cam, cfg, _ = bench.select_scene(args.scene, dev)
    isect = "clustered" if args.scene else "pallas"
    plan, _ = bench._plan(env, "grad", args.scene, scene, cam, cfg,
                          rng.base_key(0), isect)
    fn = bench.INTERSECT_FN[isect]
    plan.run(fn)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            plan.run(fn)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    print(json.dumps({"scene": args.scene or "final", "kernel": plan.kernel,
                      "syncs": len(syncs), "sites": dict(sites),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
