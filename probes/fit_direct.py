"""The direct gradient step, graphed against eager, in turns.

The step that ``cli fit`` takes without ``--fast`` (``make_fit_step``,
``diff.grad.render_loss_and_grads``): the lockstep recorder's loop, then
the value and gradient of the replay over the whole (max_depth + 1, R)
tape.  On the final scene (random-spheres 1200x800 @ 10, depth 50, the
dense sweep) or on field5000 (800x450 @ 4, depth 50, K5 on
``pack_scene_clustered``), at ray ids [0, 2^17), zero target, every
differentiable field.  Each pair below runs eager, graphed, graphed, eager
(``--repeats`` runs a turn, the median kept), in one process:

- ``step``: ``render_loss_and_grads`` (its recorder's loop and its
  replay's value and gradient CUDA graphs) against the same recorder with
  ``graphed=False`` and the eager body ``tape_loss_and_grads``;
- ``recorder``: the lockstep recorder alone (``record_tape``);
- ``pool``: the pool recorder alone (``record_tape(record_pool=--pool)``);
- ``replay``: the value and gradient alone, on the step's tape;
- ``fit``: one ``make_fit_step`` step with Adam (the optimizer's step
  outside the graphs) against the eager step and the same Adam step;
- ``occupancy`` (``--occupancy``): ``wavefront_occupancy`` over the first
  2^14 rays (``cli occupancy``'s scan), graphed and with ``graphed=False``;
  and the wall time of ``python -m first_raytracer_tpu_torch.cli occupancy
  --preset random-spheres`` in a subprocess (graphed; its megakernel
  reports included).

Also: the recorder's flag reads and block replays per step, the first
call's captures (warm-up and capture seconds, pool bytes) of the
recorder's loop and of the replay, peak memory of a step each way, and the
graph against eager (tapes equal, the loss's difference in float32 ulps,
the gradients' largest relative difference).  Prints one JSON line, and
writes it to ``--out`` when given.

    python probes/fit_direct.py --occupancy
    python probes/fit_direct.py --scene field5000
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as dg  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic  # noqa: E402,E501
from first_raytracer_tpu_torch.render.graphed import LOOPS  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501
from first_raytracer_tpu_torch.utils.metrics import wavefront_occupancy  # noqa: E402,E501


def host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def in_turns(pairs, repeats):
    """{name: [median of the first turn, ... of the fourth]} of each
    (eager, graphed) pair run eager, graphed, graphed, eager."""
    out = {}
    for name, (eager, graphed) in pairs.items():
        host_s(eager)
        host_s(graphed)
        turns = {"eager": [], "graphed": []}
        for run, fn in (("eager", eager), ("graphed", graphed),
                        ("graphed", graphed), ("eager", eager)):
            turns[run].append(statistics.median(
                host_s(fn)[0] for _ in range(repeats)))
        out[name] = turns
    return out


def peak_gb(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_s(fn)
    return torch.cuda.max_memory_allocated() / 1e9


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="final", choices=("final",
                                                         "field5000"))
    ap.add_argument("--rays", type=int, default=1 << 17)
    ap.add_argument("--pool", type=int, default=1 << 14)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--occupancy", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    dev = torch.device("cuda")
    if args.scene == "final":
        scene, cam, cfg = build_preset("random-spheres", device=dev)
        accel = None
    else:
        scene, cam, cfg = build_preset("sphere-field", device=dev, n=5000)
        accel = ic.pack_scene_clustered(scene)
    R = args.rays
    key = rng.base_key(0)
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)
    common = (scene, cam, cfg, key, ids)

    def record(graphed=None, pool=0):
        return dg.record_tape(params, *common, accel, record_pool=pool,
                              graphed=graphed)

    def eager_step(p=params):
        tape = dg.record_tape(p, *common, accel, graphed=False)
        return tape, dg.tape_loss_and_grads(p, scene, cam, key, ids, target,
                                            tape, cfg=cfg)

    # The first graphed step: its captures.
    caps = (LOOPS.captures, dg.GRAPHS.captures)
    first_s, _ = host_s(lambda: dg.render_loss_and_grads(
        params, *common, target, accel))
    captures = {"first_step_s": first_s,
                "recorder": LOOPS.last if LOOPS.captures > caps[0] else None,
                "replay": dg.GRAPHS.last if dg.GRAPHS.captures > caps[1]
                else None}

    # Graph against eager.
    tape_e, (loss_e, grads_e) = eager_step()
    tape = record()
    loss, grads = dg.render_loss_and_grads(params, *common, target, accel)
    ulp = float(np.spacing(np.float32(abs(float(loss_e)))))
    check = {
        "tape_equal": bool(torch.equal(tape, tape_e)),
        "loss_ulps": abs(float(loss) - float(loss_e)) / ulp,
        "grad_rel_max": max(float(((g - grads_e[k]).abs()
                                   / grads_e[k].abs()).nan_to_num(0.0).max())
                            for k, g in grads.items() if g.numel()),
        "loss": float(loss)}

    # Host reads of one graphed step.
    LOOPS.reset_counts()
    replays0 = dg.GRAPHS.replays
    host_s(lambda: dg.render_loss_and_grads(params, *common, target, accel))
    reads = {"flag_reads": LOOPS.syncs, "block_replays": LOOPS.replays,
             "passes": LOOPS.passes, "live_passes": LOOPS.live_passes,
             "replay_graphs": dg.GRAPHS.replays - replays0}

    # One make_fit_step step (Adam) against the eager step and Adam.
    fit_p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    eager_p = {k: v.detach().clone().requires_grad_(True)
               for k, v in params.items()}
    step = dg.make_fit_step(scene, cam, cfg, ids, target,
                            dg.make_optimizer("adam", fit_p, 1e-4),
                            accel=accel, device=dev)
    eager_opt = dg.make_optimizer("adam", eager_p, 1e-4)

    def eager_fit():
        _, (lo, g) = eager_step(eager_p)
        dg.apply_grads(eager_opt, eager_p, g)
        return lo

    pairs = {
        "step": (lambda: eager_step(),
                 lambda: dg.render_loss_and_grads(params, *common, target,
                                                  accel)),
        "recorder": (lambda: record(False), lambda: record()),
        "pool": (lambda: record(False, args.pool),
                 lambda: record(None, args.pool)),
        "replay": (lambda: dg.tape_loss_and_grads(
            params, scene, cam, key, ids, target, tape, cfg=cfg),
            lambda: dg.render_loss_and_grads_tape(
                params, scene, cam, cfg, key, ids, target, tape)),
        "fit": (eager_fit, lambda: step(fit_p, key)),
    }
    times = in_turns(pairs, args.repeats)
    pool_equal = bool(torch.equal(record(None, args.pool), tape))
    peaks = {"eager_step_gb": peak_gb(lambda: eager_step()),
             "graphed_step_gb": peak_gb(lambda: dg.render_loss_and_grads(
                 params, *common, target, accel))}

    out = {"probe": "fit_direct", "scene": args.scene, "rays": R,
           "pool": args.pool, "depth": cfg.max_depth,
           "accel": type(accel).__name__ if accel is not None else None,
           "times_s": times, "check": check, "pool_tape_equal": pool_equal,
           "reads_per_step": reads, "captures": captures, "peaks": peaks,
           "device": torch.cuda.get_device_name(0)}
    if args.occupancy:
        occ = {"in_process": in_turns({"occupancy": (
            lambda: wavefront_occupancy(scene, cam, cfg, accel=accel,
                                        device=dev, graphed=False),
            lambda: wavefront_occupancy(scene, cam, cfg, accel=accel,
                                        device=dev))}, args.repeats)}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "first_raytracer_tpu_torch.cli",
             "occupancy", "--preset", "random-spheres"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        occ["cli_wall_s"] = time.perf_counter() - t0
        occ["cli_rc"] = proc.returncode
        out["occupancy"] = occ
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
